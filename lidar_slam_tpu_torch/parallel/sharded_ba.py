"""Distributed Schur-complement bundle adjustment, matrix-free (counterpart
of ``lidar_slam_tpu.parallel.sharded_ba``).

``models/ba.py`` assembles the reduced (3K, 3K) pose system and solves it
densely on one device. Here the solve is block-sharded over keyframes'
factors, as the JAX package does it:

- the factor arrays (odometry E axis, observation F axis) are cut into
  equal row blocks, one a rank; each rank linearises only its own factors
  (the closed-form Jacobians of ``models/ba.py`` and of the pose graph's
  edge; the JAX package uses ``jacfwd``);
- the reduced system is never built anywhere: the Schur matvec
  S v = Hpp v - U^T Hll^-1 (U v) is evaluated factor by factor, each rank
  scatter-adding its factors' 3x3 / 3x2 block products into (K, 3)- and
  (L, 2)-shaped vectors that an all-reduce completes. No (K, K)- or
  (L, K)-shaped tensor exists on any rank at any K;
- the landmark system (block-diagonal Hll, bl) and every K- or L-shaped
  vector are replicated;
- the reduced solve is preconditioned conjugate gradients with a
  block-Jacobi (3x3 pose block) preconditioner, the Schur correction of
  its diagonal summed factor by factor.

The JAX package scatters in f32 and ``psum``s f32. Every scatter here
follows ``models/ba.py``'s rule: added locally in float64, all-reduced in
float64 and rounded to f32 once, so the sum's order (a CUDA scatter's,
the collective's) does not reach the f32 result. CG's inner products are
float64 sums rounded once, for the same reason. The 3x3 / 3x2 block
products are elementwise products summed in a fixed order (``_bmm``,
``_bmv``), not cuBLAS batched products. Gauge: pose 0 and inactive slots are exact constraints
(identity rows in the matvec), not the dense path's 1e6 prior, which
would wreck CG's conditioning. No step waits for the host.

The JAX package jits the solve under ``shard_map`` with the Gauss-Newton
iterations and the PCG steps as two nested ``fori_loop``s. Here the solve
replays three CUDA graphs with their all-reduces inside (``ShardedSolve``):
an iteration's prologue, one PCG step, and its update; ``_solve`` runs
the same three functions op by op, the reference the captured solve
equals bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from lidar_slam_tpu_torch.core import se2
from lidar_slam_tpu_torch.models.ba import (BAProblem, _inv2,
                                            _obs_jacobians, _obs_residual,
                                            _odo_residual, _true_f32)
from lidar_slam_tpu_torch.models.posegraph import _edge_jacobians
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
from lidar_slam_tpu_torch.parallel.mesh import Axis
from lidar_slam_tpu_torch.utils import graphs


def make_graph_mesh(device_type: str = "cuda") -> Axis:
    """A 1-D mesh over every rank of the world, axis name "graph"."""
    return mesh_lib.make_axis("graph", device_type)


def _pad_to(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    if x.dtype == torch.bool:
        return _pad_to(x.to(torch.uint8), n, int(fill)).to(torch.bool)
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, n - x.shape[0]),
                 value=fill)


def pad_problem(p: BAProblem, n_dev: int) -> BAProblem:
    """Pad every axis (K, L, E, F) to a multiple of ``n_dev``. Padded slots
    are inactive: they add zero to every block and their states are held
    by the exact-constraint rows."""

    def up(n):
        return -(-n // n_dev) * n_dev

    k, l = up(p.poses.shape[0]), up(p.landmarks.shape[0])
    e, f = up(p.odo_i.shape[0]), up(p.obs_i.shape[0])
    return BAProblem(
        poses=_pad_to(p.poses, k), landmarks=_pad_to(p.landmarks, l),
        pose_active=_pad_to(p.pose_active, k, False),
        lm_active=_pad_to(p.lm_active, l, False),
        odo_i=_pad_to(p.odo_i, e), odo_j=_pad_to(p.odo_j, e),
        odo_z=_pad_to(p.odo_z, e), odo_w=_pad_to(p.odo_w, e),
        odo_active=_pad_to(p.odo_active, e, False),
        obs_i=_pad_to(p.obs_i, f), obs_j=_pad_to(p.obs_j, f),
        obs_z=_pad_to(p.obs_z, f), obs_w=_pad_to(p.obs_w, f),
        obs_active=_pad_to(p.obs_active, f, False))


def _sum64(x: torch.Tensor) -> torch.Tensor:
    """A whole-tensor sum in float64, rounded to f32 once."""
    return x.to(torch.float64).sum().to(torch.float32)


# The block products below are elementwise products summed along the
# shared axis, whose kernels depend only on shapes and strides, not cuBLAS
# batched products: cuBLAS may pick another implementation while several
# streams are active, as in a captured solve beside NCCL's stream, and the
# captured solve must equal the eager one bit for bit.

def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[n] @ b[n] for batches of small blocks, (N, i, k) x (N, k, j)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _bmv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m[n] @ v[n], (N, i, k) x (N, k) -> (N, i)."""
    return (m * v[:, None, :]).sum(-1)


def _bmtv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m[n]^T @ v[n], (N, k, i) x (N, k) -> (N, i)."""
    return (m * v[:, :, None]).sum(1)


def _gram(j1: torch.Tensor, w: torch.Tensor, j2: torch.Tensor
          ) -> torch.Tensor:
    """j1[n]^T diag(w[n]) j2[n], (N, a, b), (N, a), (N, a, c) -> (N, b, c)."""
    return _bmm(j1.transpose(1, 2), w[:, :, None] * j2)


class _Scatter:
    """Sums of factor blocks over every rank: each rank adds its factors'
    values at their indices in float64, one all-reduce in float64 adds the
    ranks, and the total is rounded to f32 once."""

    def __init__(self, axis: Axis):
        self.axis = axis

    def __call__(self, shape, index, values: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(shape, dtype=torch.float64, device=values.device)
        out.index_put_((index,), values.to(torch.float64), accumulate=True)
        return self.axis.all_reduce(out).to(torch.float32)


class _Fixed(NamedTuple):
    """What every Gauss-Newton iteration reads of the problem: this rank's
    factor indices, measurements and weights, the gauge and the landmark
    damping blocks."""
    oi: torch.Tensor         # (E,) int64
    oj: torch.Tensor
    fi: torch.Tensor         # (F,) int64
    fj: torch.Tensor
    pose_idx: torch.Tensor   # (2E + F,) [oi, oj, fi]
    odo_z: torch.Tensor      # (E, 3)
    obs_z: torch.Tensor      # (F, 2)
    wo: torch.Tensor         # (E, 3) weights, inactive factors zero
    wv: torch.Tensor         # (F, 2)
    fixed: torch.Tensor      # (K,) bool: pose 0 and inactive slots
    notfix: torch.Tensor     # (K, 1) f32
    fixf: torch.Tensor       # (K, 1) f32
    lm_damp: torch.Tensor    # (L, 2, 2)
    lm_on: torch.Tensor      # (L, 1) f32


class _Linear(NamedTuple):
    """One iteration's linearisation: what its PCG steps and its
    back-substitution read."""
    h_ii: torch.Tensor       # (E, 3, 3)
    h_jj: torch.Tensor
    h_ij: torch.Tensor
    hpp_o: torch.Tensor      # (F, 3, 3)
    hpl_o: torch.Tensor      # (F, 3, 2)
    hll_inv: torch.Tensor    # (L, 2, 2)
    bl: torch.Tensor         # (L, 2)
    minv: torch.Tensor       # (K, 3, 3) the preconditioner's blocks


class _Cg(NamedTuple):
    """The PCG state."""
    x: torch.Tensor          # (K, 3)
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor         # ()


def _fixed(pose_active, lm_active, fac, damping: float) -> _Fixed:
    kmax = pose_active.shape[0]
    dev = pose_active.device
    fixed = (~pose_active) | (torch.arange(kmax, device=dev) == 0)
    oi, oj = fac.odo_i.long(), fac.odo_j.long()
    fi, fj = fac.obs_i.long(), fac.obs_j.long()
    eye2 = torch.eye(2, dtype=torch.float32, device=dev)
    return _Fixed(
        oi=oi, oj=oj, fi=fi, fj=fj, pose_idx=torch.cat([oi, oj, fi]),
        odo_z=fac.odo_z, obs_z=fac.obs_z,
        wo=fac.odo_w * fac.odo_active.to(torch.float32)[:, None],
        wv=fac.obs_w * fac.obs_active.to(torch.float32)[:, None],
        fixed=fixed, notfix=(~fixed).to(torch.float32)[:, None],
        fixf=fixed.to(torch.float32)[:, None],
        lm_damp=(damping + (~lm_active).to(torch.float32))[:, None, None]
        * eye2,
        lm_on=lm_active.to(torch.float32)[:, None])


def _precond(lin: _Linear, r: torch.Tensor) -> torch.Tensor:
    return _bmv(lin.minv, r)


def _linearize(fx: _Fixed, poses, lms, psum, damping: float
               ) -> tuple[_Linear, _Cg]:
    """This rank's factors linearised at (poses, lms), the small systems
    completed over the ranks, the preconditioner and the PCG's start."""
    kmax, lmax = poses.shape[0], lms.shape[0]
    eye3 = torch.eye(3, dtype=torch.float32, device=poses.device)
    oi, oj, fi, fj = fx.oi, fx.oj, fx.fi, fx.fj
    # --- this rank's factors, linearised
    xi, xj = poses[oi], poses[oj]
    ji, jj = _edge_jacobians(xi, xj)
    ro = _odo_residual(xi, xj, fx.odo_z)
    wo, wv = fx.wo, fx.wv
    h_ii = _gram(ji, wo, ji)      # (E, 3, 3)
    h_jj = _gram(jj, wo, jj)
    h_ij = _gram(ji, wo, jj)
    b_i = _bmtv(ji, wo * ro)
    b_j = _bmtv(jj, wo * ro)
    xo, lo = poses[fi], lms[fj]
    jp, jl = _obs_jacobians(xo, lo)
    rv = _obs_residual(xo, lo, fx.obs_z)
    hpp_o = _gram(jp, wv, jp)     # (F, 3, 3)
    hll_o = _gram(jl, wv, jl)     # (F, 2, 2)
    hpl_o = _gram(jp, wv, jl)     # (F, 3, 2)
    bp_o = _bmtv(jp, wv * rv)
    bl_o = _bmtv(jl, wv * rv)

    # --- the small systems, K- and L-shaped, completed over the ranks
    bp = psum((kmax, 3), fx.pose_idx, torch.cat([b_i, b_j, bp_o]))
    hll = psum((lmax, 2, 2), fj, hll_o) + fx.lm_damp
    bl = psum((lmax, 2), fj, bl_o)
    hll_inv = _inv2(hll)

    # --- reduced RHS b_red = bp - U^T Hll^-1 bl, factor by factor
    zb = _bmv(hll_inv, bl)
    corr = psum((kmax, 3), fi, _bmv(hpl_o, zb[fj]))
    rhs = -(bp - corr) * fx.notfix

    # --- block-Jacobi preconditioner: exact Hpp diagonal blocks less the
    # factor-wise Schur diagonal correction
    sdiag = _bmm(_bmm(hpl_o, hll_inv[fj]), hpl_o.transpose(1, 2))
    dpp = psum((kmax, 3, 3), torch.cat([oi, oj, fi, fi]),
               torch.cat([h_ii, h_jj, hpp_o, -sdiag]))
    dblocks = torch.where(fx.fixed[:, None, None], eye3,
                          dpp + damping * eye3)
    minv, _ = torch.linalg.inv_ex(dblocks)
    # contiguous, as the captured solve's buffers are (``inv_ex`` returns
    # column-major blocks): a product over another layout sums in another
    # order
    lin = _Linear(*(t.contiguous() for t in (h_ii, h_jj, h_ij, hpp_o, hpl_o,
                                             hll_inv, bl, minv)))

    # --- PCG on S dp = rhs from x = 0
    z = _precond(lin, rhs)
    return lin, _Cg(torch.zeros_like(rhs), rhs, z, z, _sum64(rhs * z))


def _matvec(fx: _Fixed, lin: _Linear, v, psum, damping: float):
    """S v factor by factor; v and the result replicated (K, 3)."""
    kmax, lmax = v.shape[0], lin.bl.shape[0]
    oi, oj, fi, fj = fx.oi, fx.oj, fx.fi, fx.fj
    vm = v * fx.notfix
    y = psum((kmax, 3), fx.pose_idx, torch.cat([
        _bmv(lin.h_ii, vm[oi]) + _bmv(lin.h_ij, vm[oj]),
        _bmtv(lin.h_ij, vm[oi]) + _bmv(lin.h_jj, vm[oj]),
        _bmv(lin.hpp_o, vm[fi])]))
    # the Schur term: U spans ranks, so U^T vm is summed before Hll^-1
    yl = psum((lmax, 2), fj, _bmtv(lin.hpl_o, vm[fi]))
    zl = _bmv(lin.hll_inv, yl)
    y = y - psum((kmax, 3), fi, _bmv(lin.hpl_o, zl[fj]))
    return y * fx.notfix + v * fx.fixf + damping * vm


def _cg_step(fx: _Fixed, lin: _Linear, cg: _Cg, psum, damping: float
             ) -> _Cg:
    """One PCG step: three all-reduces (the matvec's) and two float64
    inner products."""
    ap = _matvec(fx, lin, cg.p, psum, damping)
    den = _sum64(cg.p * ap)
    alpha = torch.where(den.abs() > 1e-20, cg.rz / den,
                        torch.zeros_like(den))
    x = cg.x + alpha * cg.p
    r = cg.r - alpha * ap
    z = _precond(lin, r)
    rz_new = _sum64(r * z)
    beta = torch.where(cg.rz.abs() > 1e-20, rz_new / cg.rz,
                       torch.zeros_like(cg.rz))
    return _Cg(x, r, z, z + beta * cg.p, rz_new)


def _update(fx: _Fixed, lin: _Linear, cg: _Cg, poses, lms, psum):
    """The landmark back-substitution (replicated, 2x2 blocks) and the
    new poses and landmarks."""
    dp = cg.x * fx.notfix
    hlp_dp = psum((lms.shape[0], 2), fx.fj,
                  _bmtv(lin.hpl_o, dp[fx.fi]))
    dl = _bmv(lin.hll_inv, -lin.bl - hlp_dp) * fx.lm_on
    new = poses + dp
    return (torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], dim=1),
            lms + dl)


def _solve(poses0, lms0, pose_active, lm_active, fac, psum, iters: int,
           cg_iters: int, damping: float):
    """Damped Gauss-Newton with the matrix-free Schur PCG, op by op (the
    captured ``ShardedSolve``'s reference); ``fac`` holds this rank's factor
    rows, the state is replicated. No step waits for the host."""
    fx = _fixed(pose_active, lm_active, fac, damping)
    poses, lms = poses0, lms0
    for _ in range(iters):
        lin, cg = _linearize(fx, poses, lms, psum, damping)
        for _ in range(cg_iters):
            cg = _cg_step(fx, lin, cg, psum, damping)
        poses, lms = _update(fx, lin, cg, poses, lms, psum)
    return poses, lms


class _Static(NamedTuple):
    """The captured solve's static buffers."""
    fixed: _Fixed
    poses: torch.Tensor
    lms: torch.Tensor
    lin: _Linear
    cg: _Cg


class ShardedSolve:
    """``ShardedSolve(axis)(poses0, lms0, pose_active, lm_active, fac,
    iters, cg_iters, damping)``: ``_solve`` as three CUDA graphs over
    static buffers (JAX's two nested ``fori_loop``s): the prologue
    (``_linearize``: the factors, the five block sums with their
    all-reduces, the preconditioner and the PCG's start), one PCG step
    (``_cg_step``), replayed ``cg_iters`` times, and the back-substitution
    with the pose update (``_update``). An iteration replays them
    ``cg_iters + 2`` times and the solve reads nothing on the host. The
    graphs hold the collectives; the axis's counts are booked a replay.
    One problem shape's buffers and graphs, on one device, are kept between
    calls (the prologue's and the PCG step's a damping); another shape or
    device makes them anew. ``optimize_ba_sharded`` keeps one an axis
    (``Axis.ba_solve``). On the CPU the same bodies run on the same
    buffers."""

    def __init__(self, axis: Axis):
        self.axis, self.psum = axis, _Scatter(axis)
        self.bufs: _Static | None = None
        self.shapes = None
        self.graphs = None

    def __call__(self, poses0, lms0, pose_active, lm_active, fac,
                 iters: int, cg_iters: int, damping: float):
        fx = _fixed(pose_active, lm_active, fac, damping)
        shapes = (poses0.device,) + tuple(tuple(t.shape)
                                          for t in (*fx, poses0, lms0))
        if shapes != self.shapes:
            self.shapes = shapes
            self.graphs = graphs.Graphs(poses0.device, counters=(
                graphs.COUNTED + (self.axis,)))
            e, f = fx.oi.shape[0], fx.fi.shape[0]
            k, l = poses0.shape[0], lms0.shape[0]

            def zeros(*shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=poses0.device)

            self.bufs = _Static(
                graphs.clone_tree(fx), poses0.clone(), lms0.clone(),
                _Linear(zeros(e, 3, 3), zeros(e, 3, 3), zeros(e, 3, 3),
                        zeros(f, 3, 3), zeros(f, 3, 2), zeros(l, 2, 2),
                        zeros(l, 2), zeros(k, 3, 3)),
                _Cg(zeros(k, 3), zeros(k, 3), zeros(k, 3), zeros(k, 3),
                    zeros()))
        else:
            graphs.copy_into(self.bufs[:3], (fx, poses0, lms0))
        for _ in range(iters):
            self.graphs.run(("linearize", damping),
                            lambda b: self._linearize(b, damping), self.bufs)
            for _ in range(cg_iters):
                self.graphs.run(("cg", damping),
                                lambda b: self._cg(b, damping), self.bufs)
            self.graphs.run("update", self._update, self.bufs)
        return self.bufs.poses.clone(), self.bufs.lms.clone()

    def _linearize(self, b: _Static, damping: float) -> None:
        graphs.copy_into((b.lin, b.cg), _linearize(
            b.fixed, b.poses, b.lms, self.psum, damping))

    def _cg(self, b: _Static, damping: float) -> None:
        graphs.copy_into(b.cg, _cg_step(b.fixed, b.lin, b.cg, self.psum,
                                        damping))

    def _update(self, b: _Static) -> None:
        graphs.copy_into((b.poses, b.lms), _update(
            b.fixed, b.lin, b.cg, b.poses, b.lms, self.psum))


def optimize_ba_sharded(p: BAProblem, axis: Axis | None = None,
                        iters: int = 10, damping: float = 1e-3,
                        cg_iters: int | None = None, eager: bool = False
                        ) -> BAProblem:
    """Distributed damped Gauss-Newton with Schur landmark elimination, a
    drop-in for ``models.ba.optimize_ba``, every rank of ``axis`` (default:
    a "graph" mesh over the world) calling it with the whole problem.
    ``cg_iters`` defaults to three times the padded pose count (an exact
    solve in exact arithmetic); the block-Jacobi preconditioner makes a few
    dozen enough at scale. The solve runs captured (the axis's
    ``ShardedSolve``, which replays the graphs an earlier call on the same
    problem shape captured), or with ``eager`` op by op. Returns the
    problem with the optimised poses and landmarks, the same on every
    rank."""
    if axis is None:
        axis = make_graph_mesh(p.poses.device.type)
    pp = pad_problem(p, axis.size)
    if cg_iters is None:
        cg_iters = 3 * pp.poses.shape[0]
    fac = pp._replace(**{f: axis.rows(getattr(pp, f)) for f in (
        "odo_i", "odo_j", "odo_z", "odo_w", "odo_active",
        "obs_i", "obs_j", "obs_z", "obs_w", "obs_active")})
    args = (pp.poses, pp.landmarks, pp.pose_active, pp.lm_active, fac)
    with _true_f32():
        if eager:
            poses, lms = _solve(*args, _Scatter(axis), int(iters),
                                int(cg_iters), float(damping))
        else:
            if axis.ba_solve is None:
                axis.ba_solve = ShardedSolve(axis)
            poses, lms = axis.ba_solve(*args, int(iters), int(cg_iters),
                                       float(damping))
    return p._replace(poses=poses[:p.poses.shape[0]],
                      landmarks=lms[:p.landmarks.shape[0]])


def optimize_job(p: BAProblem, iters: int, cg_iters: int | None = None,
                 device_type: str = "cuda", eager: bool = False):
    """``optimize_ba_sharded`` on a new graph mesh over the whole world: a
    job for ``multihost.launch`` (``p`` as numpy fields). Returns (poses,
    landmarks)."""
    prob = BAProblem(*(torch.as_tensor(v, device=device_type) for v in p))
    out = optimize_ba_sharded(prob, make_graph_mesh(device_type), iters,
                              cg_iters=cg_iters, eager=eager)
    return out.poses, out.landmarks
