"""Grid-based Rao-Blackwellized particle filter, FastSLAM-style
(counterpart of ``lidar_slam_tpu.models.fastslam``).

Particles are a leading batch axis. Each step propagates them with constant
velocity plus Gaussian proposal noise, builds the correlation volume(s)
around their mean (kernel K2 on CUDA), optionally lets every particle descend
the interpolated volume (autograd through the lookup), weights every
particle by trilinear lookups (one launch of kernel K4 on CUDA), resamples
systematically under an ESS gate without a host branch, refines the
weighted-mean estimate with three argmin passes over 27 candidates (one K4
launch for all three), and on keyframe steps appends novel points and
rebuilds the fine raster and its EDT (kernel K1 on CUDA). In the eager
``pf_step`` the keyframe test is the step's one device->host sync:
``pf_step`` is ``pf_head`` up to it and ``pf_refresh`` after it.
``make_pf_step`` (JAX's jitted step) captures both as one CUDA graph over
static buffers (``utils/graphs``), the refresh in a conditional node on the
device test (JAX's ``lax.cond``), so ``run_pf`` runs every scan after the
first with no host sync.

Reductions over the particles (the mean, softmax, CDF and weighted sums)
and the volume's cos/sin are evaluated in float64 and rounded to f32: their
order and the libm differ between the CPU and the card, and in float64 the
rounded f32 result no longer depends on either, so the CPU and CUDA paths
take the same argmin and resampling decisions on the same draws.

Random numbers come from the ``torch.Generator`` carried in the state;
``pf_step`` also takes ``draws=(noise, u0)`` so a test can feed both
packages the same proposal noise and resampling offset.

While a profiler runs, ``run_pf`` is one ``session`` span, each captured
step's draws and their copies into its static buffers are a ``pf.draw``
span, the counter ``pf.refreshes`` gets the run's keyframe refreshes
(``PfStepFn.refreshes``) and the counter ``k4.launches`` its K4 launches.

A step may hold only a block of the particles (``parallel/sharded.py``):
its ``rows`` hook gathers a per-particle tensor from every block and slices
this block's rows back out. Every cross-particle value (the mean, the ESS,
the CDF, the max, the weighted estimate) is then reduced from the gathered
tensor by the code and in the order of the single-process step, and every
block draws the full (P, 3) noise from the shared generator and keeps its
rows, so a sharded run equals the unsharded one bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.config import SlamConfig
from lidar_slam_tpu_torch.core import gridmap, se2, sensor
from lidar_slam_tpu_torch.core.gridmap import OccGrid, PointMap
from lidar_slam_tpu_torch.device import constant, resolve_device
from lidar_slam_tpu_torch.models.scan_matcher import (angles_tensor,
                                                      pose_and_test)
from lidar_slam_tpu_torch.ops import correlative, cuda_vol_lookup
from lidar_slam_tpu_torch.ops import edt as edt_ops
from lidar_slam_tpu_torch.ops import matching
from lidar_slam_tpu_torch.utils import graphs
from lidar_slam_tpu_torch.utils.profiling import SPANS, session, span


class ParticleState(NamedTuple):
    poses: torch.Tensor        # (P, 3)
    prev_poses: torch.Tensor   # (P, 3) per-particle constant-velocity memory
    logw: torch.Tensor         # (P,) log importance weights
    step: int
    mini_updated: bool
    pmap: PointMap
    fine: OccGrid
    fine_metric: torch.Tensor  # (Sf, Sf) f32
    rng: torch.Generator       # on the state's device
    clamp_frac: torch.Tensor   # () f32 — particles that escaped the fine
                               # scoring window this step (diagnostic)


def init_particles(ranges0: torch.Tensor, cfg: SlamConfig, seed: int = 0,
                   pose0=(0.0, 0.0, 0.0)) -> ParticleState:
    dev = ranges0.device
    p = cfg.particles.n_particles
    scan = sensor.read_scan(ranges0, angles_tensor(cfg, dev), cfg.lidar)
    pose = torch.tensor(pose0, dtype=torch.float32, device=dev)
    wx, wy = se2.transform_ref(scan.x, scan.y, pose)
    pmap = gridmap.init_point_map(wx, wy, scan.valid, pose,
                                  cfg.map.map_capacity)
    g = cfg.grid
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    return ParticleState(
        poses=pose.repeat(p, 1), prev_poses=pose.repeat(p, 1),
        logw=torch.zeros(p, dtype=torch.float32, device=dev),
        step=1, mini_updated=True, pmap=pmap,
        fine=gridmap.empty_grid(g.fine_size, g.fine_pixel, dev),
        fine_metric=torch.zeros((g.fine_size, g.fine_size),
                                dtype=torch.float32, device=dev),
        rng=rng, clamp_frac=torch.zeros((), dtype=torch.float32, device=dev))


class AllRows:
    """The particle rows of a step that holds every particle: gathering is
    the identity and this process's rows are all rows. The sharded
    counterpart is ``parallel.mesh.Axis``."""

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every particle's rows of a per-particle tensor."""
        return x

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of an every-particle tensor."""
        return x


ALL_ROWS = AllRows()


def _softmax64(logw: torch.Tensor) -> torch.Tensor:
    """Softmax evaluated in float64: see ``pf_step`` on reductions."""
    return torch.softmax(logw.to(torch.float64), dim=0)


def systematic_resample(u0: torch.Tensor, logw: torch.Tensor) -> torch.Tensor:
    """Systematic (low-variance) resampling: ancestor indices (P,) for the
    comb ``u0 + i/P``, ``u0`` in [0, 1/P). ``searchsorted(side="left")`` on
    the f32 CDF gives the same indices as the JAX package's compare-count
    ``#{j : c_j < u_i}``."""
    p = logw.shape[0]
    w = _softmax64(logw).to(torch.float32)
    c = torch.cumsum(w.to(torch.float64), dim=0).to(torch.float32)
    u = u0 + correlative.true_div(
        torch.arange(p, dtype=torch.float32, device=logw.device), p)
    idx = torch.searchsorted(c, u, side="left")
    return torch.clamp(idx, 0, p - 1)


def effective_sample_size(logw: torch.Tensor) -> torch.Tensor:
    w = _softmax64(logw)
    return (1.0 / torch.sum(w * w)).to(torch.float32)


def draw(state: ParticleState, p: int | None = None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step's draws from the state's generator: standard-normal proposal
    noise (P, 3) and the resampling offset u0 in [0, 1/P). ``p`` is the
    number of particles in all blocks (default: the state's rows)."""
    p = state.poses.shape[0] if p is None else p
    dev = state.poses.device
    noise = torch.randn((p, 3), generator=state.rng, device=dev)
    u0 = torch.rand((), generator=state.rng, device=dev) / p
    return noise, u0


_OFFS27 = np.stack(np.meshgrid(*([np.asarray([-1.0, 0.0, 1.0], np.float32)] * 3),
                               indexing="ij"), axis=-1).reshape(27, 3)


class PfHead(NamedTuple):
    """A particle-filter step up to its keyframe test (``pf_head``)."""
    state: ParticleState      # the next state if the test fails
    scan: sensor.Scan
    est_pose: torch.Tensor    # (3,) the step's estimate
    test: torch.Tensor        # () bool, the mini-update rule's test


def pf_head(state: ParticleState, ranges: torch.Tensor, cfg: SlamConfig,
            angles: torch.Tensor, draws=None,
            rows: AllRows = ALL_ROWS) -> PfHead:
    """A step up to its keyframe test: propagate, build the volumes, look
    up, resample, estimate, test. No host sync. Arguments as ``pf_step``."""
    pc, m, mc = cfg.particles, cfg.map, cfg.matcher
    dev = state.poses.device
    p = pc.n_particles
    scan = sensor.read_scan(ranges, angles, cfg.lidar)
    noise, u0 = draw(state, p) if draws is None else draws
    noise = rows.rows(torch.as_tensor(noise, dtype=torch.float32, device=dev))
    u0 = torch.as_tensor(u0, dtype=torch.float32, device=dev)

    # --- propagate: per-particle constant velocity + Gaussian proposal noise
    vel = state.poses - state.prev_poses
    sigma = constant((pc.sigma_xy, pc.sigma_xy, pc.sigma_theta), dev)
    prop = state.poses + vel + noise * sigma

    # --- correlation volume(s) around the predicted mean pose
    prop_all = rows.gather(prop)
    base = prop_all.to(torch.float64).mean(dim=0).to(torch.float32)
    vols = correlative.build_cascade(
        state.fine_metric, state.fine, scan.x, scan.y, scan.valid, base,
        n_theta=pc.vol_theta_bins, theta_step=mc.fine_r, half=pc.vol_half,
        levels=pc.cascade_levels)
    # --- gradient-guided proposal refinement: each particle descends the
    # interpolated fine volume a few capped steps before weighting. A
    # particle's distance depends on its own pose only, so the gradient of
    # the sum is every particle's own gradient.
    if pc.grad_refine_steps > 0:
        caps = constant((pc.grad_step_xy, pc.grad_step_xy,
                         pc.grad_step_theta), dev)
        for _ in range(pc.grad_refine_steps):
            with torch.enable_grad():
                at = prop.detach().requires_grad_(True)
                d = correlative.lookup_avg_distance(vols[0], at)
                (grad,) = torch.autograd.grad(d.sum(), at)
            prop = prop + torch.clamp(-0.01 * grad, -caps, caps)
        prop_all = rows.gather(prop)
    avg_dist, fine_escape = correlative.lookup_cascade(vols, prop)
    clamp_frac = rows.gather(fine_escape).to(torch.float32).mean()

    # --- importance weighting and resampling under the ESS gate, over
    # every particle; this block keeps its rows of the result
    logw = rows.gather(state.logw
                       - correlative.true_div(avg_dist, pc.score_temperature))
    do_resample = effective_sample_size(logw) < pc.resample_threshold * p
    idx = torch.where(do_resample, systematic_resample(u0, logw),
                      torch.arange(p, device=dev))
    poses = rows.gather(state.poses)
    resampled_poses = prop_all[idx]
    prev_for_vel = torch.where(do_resample, poses[idx], poses)
    logw = torch.where(do_resample, torch.zeros_like(logw), logw)
    logw = logw - logw.max()

    # --- estimate: weighted mean + three 27-candidate argmin refinements
    w_norm = _softmax64(logw)
    est_pose = torch.sum(w_norm[:, None] * resampled_poses.to(torch.float64),
                         dim=0).to(torch.float32)
    steps = np.asarray([mc.fine_t, mc.fine_t, mc.fine_r], np.float32)
    offs = constant(tuple(map(tuple, (_OFFS27 * steps).tolist())), dev)
    est_pose = correlative.refine_estimate(vols, est_pose, offs)

    # --- the mini-update rule's test
    dp = torch.abs(est_pose - state.pmap.keyframe_pose)
    test = ((dp[0] > m.mini_update_dt) | (dp[1] > m.mini_update_dt)
            | (dp[2] > m.mini_update_dr))
    kept = state._replace(
        poses=rows.rows(resampled_poses), prev_poses=rows.rows(prev_for_vel),
        logw=rows.rows(logw), step=state.step + 1, mini_updated=False,
        clamp_frac=clamp_frac)
    return PfHead(state=kept, scan=scan, est_pose=est_pose, test=test)


def pf_raster(head: PfHead, first: bool, cfg: SlamConfig) -> ParticleState:
    """``pf_refresh`` up to its field: append the novel points, crop and
    raster; the state keeps its current ``fine_metric``."""
    g, m = cfg.grid, cfg.map
    st, scan, est_pose = head.state, head.scan, head.est_pose
    wx, wy = se2.transform_ref(scan.x, scan.y, est_pose)
    if first:
        novel = scan.valid   # the field is still empty: seed from all
    else:
        # novel-surface test against the current field (main.c:943)
        _, hits, inb = matching.score_candidates(
            st.fine_metric, st.fine, scan.x, scan.y, scan.valid,
            est_pose[None])
        novel = (hits[0] > m.new_point_threshold) & inb[0]
    pmap = gridmap.append_points(st.pmap, wx, wy, novel, est_pose)
    local = gridmap.extract_local_map(pmap, wx, wy, scan.valid,
                                      g.border_size)
    min_xy, max_xy = gridmap.local_bounds(local)
    fine = gridmap.rasterize(local, g.fine_pixel, g.fine_size, min_xy,
                             max_xy, g.margin_pixels)
    return st._replace(mini_updated=True, pmap=pmap, fine=fine)


def pf_refresh(head: PfHead, first: bool, cfg: SlamConfig, edt_fn=None
               ) -> ParticleState:
    """The keyframe refresh when the test passed (or on the first step,
    ``first``, whose field is still empty): append the novel points, crop,
    raster (``pf_raster``), and the keyframe field (``edt_fn``, as
    ``pf_step``)."""
    edt_fn = edt_ops.edt if edt_fn is None else edt_fn
    st = pf_raster(head, first, cfg)
    return st._replace(fine_metric=edt_fn(st.fine.occ,
                                          int(cfg.grid.max_dist_px)))


def pf_step(state: ParticleState, ranges: torch.Tensor, cfg: SlamConfig,
            angles: torch.Tensor, draws=None, edt_fn=None,
            rows: AllRows = ALL_ROWS) -> tuple[ParticleState, torch.Tensor]:
    """One particle-filter step: ``pf_head``, the keyframe test on the
    host (the step's one sync; none on the first step, which always
    refreshes), ``pf_refresh`` if it passed. Returns (state, best_pose).

    ``draws=(noise (P, 3) standard normal, u0 scalar in [0, 1/P))`` replaces
    the state's generator for this step. ``edt_fn(occ, max_dist)`` computes
    the keyframe field (default ``ops/edt.edt``: kernel K1 on CUDA; the
    sharded pipeline passes the row-block transform of
    ``parallel/sharded_edt.py``). ``rows``: see the module docstring; the
    state then holds this block's rows of ``poses``, ``prev_poses`` and
    ``logw``, and P is ``cfg.particles.n_particles`` over all blocks.
    """
    head = pf_head(state, ranges, cfg, angles, draws, rows)
    first = state.step == 1
    if first or bool(head.test.item()):
        return pf_refresh(head, first, cfg, edt_fn), head.est_pose
    return head.state, head.est_pose


class _PfStatic(NamedTuple):
    """The captured PF step's static buffers."""
    ranges: torch.Tensor   # (N,)
    noise: torch.Tensor    # (P, 3) the step's proposal noise
    u0: torch.Tensor       # () the step's resampling offset
    head: PfHead           # head.state is the step's state
    out: torch.Tensor      # (4,) the estimate and the test
    block: torch.Tensor | None   # this rank's rows of the field (a split
    #                              edt_fn's; None otherwise)


class PfStepFn:
    """``step(state, ranges, draws=None) -> (state, pose)``: ``pf_step`` as
    one captured CUDA graph (``utils/graphs``), JAX's jitted step with its
    state donated: the head, then an IF node on the device test holding
    ``pf_refresh``. A step draws its noise and offset with ``draw`` from
    the state's generator (or uploads ``draws``) into static buffers, the
    eager step's stream: the same generator calls in the same order.
    ``advance(state, ranges, draws=None)`` replays the graph and reads
    nothing on the host (the state's ``mini_updated`` is the device test;
    ``finish`` reads it back with the arm's launch count); ``step(...)``
    also reads the estimate and the test in one 16-byte device->host copy.
    Scan 1 (``state.step == 1``) runs eagerly. ``refreshes()`` counts the
    keyframe refreshes the step has run.

    The returned state's tensors are the step's static buffers, valid until
    the next call, which takes the state back; a state the step did not
    return is copied in first (``scan_matcher.StepFn`` has the details).
    ``self.pose`` is the step's estimate on the device and ``self.scan``
    its gated scan (None after the eager scan 1), valid until the next
    call.

    ``rows`` and ``edt_fn`` are ``pf_step``'s: a sharded step
    (``parallel/sharded.py``) holds a block of the particles, and its
    collectives are captured in the main graph with its kernels, none
    inside the IF node (the card's NCCL refuses a collective of two or
    more ranks in a conditional body). An ``edt_fn`` that gathers comes
    with its halves (``sharded_edt.ReplicatedField``: ``local``,
    ``assemble``, ``block``): the arm then runs ``pf_raster`` and writes
    this rank's block of the field into a static buffer, and after the IF
    node the main graph all-gathers that buffer into the state's
    ``fine_metric`` on every scan (after a scan with no keyframe, the same
    blocks again). The noise buffer holds the full (P, 3), drawn from the
    replicated generator; the body keeps its rows. ``axes``: the mesh axes
    whose collectives the step runs, booked once a replay as the kernels'
    launches are."""

    def __init__(self, cfg: SlamConfig, device: str | torch.device = "cuda",
                 rows: AllRows = ALL_ROWS, edt_fn=None, axes=()):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rows, self.edt_fn = rows, edt_fn
        self.split = hasattr(edt_fn, "assemble")   # the field's two halves
        self.angles = angles_tensor(cfg, self.device)
        self.graphs = graphs.Graphs(self.device,
                                    counters=graphs.COUNTED + tuple(axes))
        self.bufs: _PfStatic | None = None
        self.state: ParticleState | None = None   # the state last returned
        self.pose: torch.Tensor | None = None
        self.scan: sensor.Scan | None = None
        # refreshes that no captured arm counts: scan 1's, which runs
        # eagerly, and on the CPU, where nothing is captured, the arm's
        self._host_refreshes = 0

    def refreshes(self) -> int:
        """The keyframe refreshes this step has run: scan 1's and the
        refresh arm's. On the card the arm's come from its launch counter,
        read back by the last ``finish`` (or ``graphs.fetch``)."""
        return self._host_refreshes + sum(arm.settled
                                          for arm in self.graphs.arms)

    def __call__(self, state: ParticleState, ranges: torch.Tensor,
                 draws=None) -> tuple[ParticleState, np.ndarray]:
        if state.step == 1:
            state = self._first(state, ranges, draws)
            return state, self.pose.cpu().numpy()
        self._replay(state, ranges, draws)
        host = self.bufs.out.to("cpu", copy=True)   # a copy on the CPU too
        self.state = self.state._replace(mini_updated=bool(host[3]))
        return self.state, host[:3].numpy()

    def advance(self, state: ParticleState, ranges: torch.Tensor,
                draws=None) -> ParticleState:
        """One step with no host read after scan 1 (it runs under the sync
        debug mode "error" on the card): the returned state's
        ``mini_updated`` is the step's device test."""
        if state.step == 1:
            return self._first(state, ranges, draws)
        with graphs.no_host_sync(self.device):
            self._replay(state, ranges, draws)
        return self.state

    def finish(self, state: ParticleState) -> ParticleState:
        """``state`` with its ``mini_updated`` read back to a host bool,
        and the step's conditional launches counted: the run's one host
        read (``graphs.finish``)."""
        return graphs.finish(self, state)

    def _first(self, state: ParticleState, ranges: torch.Tensor, draws):
        ranges = ranges.to(self.device, non_blocking=True)
        state, self.pose = pf_step(state, ranges, self.cfg, self.angles,
                                   draws, self.edt_fn, self.rows)
        self.scan = None
        self._host_refreshes += 1     # scan 1 always refreshes
        return state

    def _replay(self, state: ParticleState, ranges: torch.Tensor,
                draws) -> None:
        if state is not self.state:
            self._load(state)
        b = self.bufs
        b.ranges.copy_(ranges, non_blocking=True)
        # eager launches outside the graph: a span that encloses device
        # work, so not in kineto's trace
        with span("pf.draw"):
            if draws is None:
                noise, u0 = draw(state, self.cfg.particles.n_particles)
                b.noise.copy_(noise)
                b.u0.copy_(u0)
            else:
                graphs.upload(b.noise, np.asarray(draws[0], np.float32))
                graphs.upload(b.u0, np.asarray(draws[1], np.float32))
        self.graphs.run("step", self._body, b)
        if not self.graphs.capturing:     # the CPU ran the arm if it held
            self._host_refreshes += int(bool(b.head.test))
        self.state = b.head.state._replace(step=state.step + 1,
                                           mini_updated=b.head.test,
                                           rng=state.rng)
        self.pose, self.scan = b.head.est_pose, b.head.scan

    def _load(self, state: ParticleState) -> None:
        if self.bufs is None:
            n, p = self.cfg.lidar.n_beams, self.cfg.particles.n_particles
            f32 = dict(dtype=torch.float32, device=self.device)
            self.bufs = _PfStatic(
                ranges=torch.zeros(n, **f32),
                noise=torch.zeros((p, 3), **f32),
                u0=torch.zeros((), **f32),
                head=PfHead(
                    state=graphs.clone_tree(state),
                    scan=sensor.empty_scan(n, self.device),
                    est_pose=torch.zeros(3, **f32),
                    test=torch.zeros((), dtype=torch.bool,
                                     device=self.device)),
                out=torch.zeros(4, **f32),
                block=(self.edt_fn.block(state.fine_metric).clone()
                       if self.split else None))
        else:
            graphs.copy_into(self.bufs.head.state, state)
            if self.split:
                self.bufs.block.copy_(self.edt_fn.block(state.fine_metric))

    def _body(self, b: _PfStatic) -> None:
        head = pf_head(b.head.state, b.ranges, self.cfg, self.angles,
                       draws=(b.noise, b.u0), rows=self.rows)
        graphs.copy_into(b.head, head)
        if not self.split:
            graphs.cond(b.head.test, lambda: graphs.copy_into(
                b.head.state, pf_refresh(b.head, False, self.cfg,
                                         self.edt_fn)))
        else:
            def refresh_block():   # no collective in the arm
                st = pf_raster(b.head, False, self.cfg)
                graphs.copy_into(b.head.state, st)
                b.block.copy_(self.edt_fn.local(
                    st.fine.occ, int(self.cfg.grid.max_dist_px)))

            graphs.cond(b.head.test, refresh_block)
            b.head.state.fine_metric.copy_(self.edt_fn.assemble(b.block))
        b.out.copy_(pose_and_test(b.head.est_pose, b.head.test))


def make_pf_step(cfg: SlamConfig, device: str | torch.device = "cuda"
                 ) -> PfStepFn:
    """The captured particle-filter step (``PfStepFn``) on ``device``."""
    return PfStepFn(cfg, device)


def run_pf(ranges_all: np.ndarray, cfg: SlamConfig, seed: int = 0,
           device: str | torch.device = "cuda", draws=None
           ) -> tuple[torch.Tensor, ParticleState]:
    """Whole-dataset particle-filter run through ``make_pf_step``, scans
    2.. with no host sync and one read at the end. ``draws``, if given, is
    a sequence of per-step ``(noise, u0)`` pairs for steps 1..T-1. Returns
    (path (T, 3) on ``device``, final state). The call is one ``session``
    span; its keyframe refreshes go to the counter ``pf.refreshes``, its K4
    launches (two a scan on the card, none on the CPU) to ``k4.launches``."""
    with session("run_pf", device):
        k4_before = cuda_vol_lookup.launches
        ranges = torch.as_tensor(np.asarray(ranges_all, np.float32),
                                 device=resolve_device(device))
        step = make_pf_step(cfg, ranges.device)
        state = init_particles(ranges[0], cfg, seed)
        path = torch.zeros((ranges.shape[0], 3), dtype=torch.float32,
                           device=ranges.device)
        for t in range(1, ranges.shape[0]):
            state = step.advance(state, ranges[t],
                                 None if draws is None else draws[t - 1])
            path[t] = step.pose
        state = graphs.clone_tree(step.finish(state))
        SPANS.count("pf.refreshes", step.refreshes())
        SPANS.count("k4.launches", cuda_vol_lookup.launches - k4_before)
        return path, state
