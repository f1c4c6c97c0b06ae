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
float64 sums rounded once, for the same reason. TF32 is off for the
block products. Gauge: pose 0 and inactive slots are exact constraints
(identity rows in the matvec), not the dense path's 1e6 prior, which
would wreck CG's conditioning. No step waits for the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lidar_slam_tpu_torch.core import se2
from lidar_slam_tpu_torch.models.ba import (BAProblem, _inv2,
                                            _obs_jacobians, _obs_residual,
                                            _odo_residual, _true_f32)
from lidar_slam_tpu_torch.models.posegraph import _edge_jacobians
from lidar_slam_tpu_torch.parallel import mesh as mesh_lib
from lidar_slam_tpu_torch.parallel.mesh import Axis


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


def _solve(poses0, lms0, pose_active, lm_active, fac, psum, iters: int,
           cg_iters: int, damping: float):
    """Damped Gauss-Newton with the matrix-free Schur PCG; ``fac`` holds
    this rank's factor rows, the state is replicated."""
    kmax, lmax = poses0.shape[0], lms0.shape[0]
    dev = poses0.device
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    eye2 = torch.eye(2, dtype=torch.float32, device=dev)
    fixed = (~pose_active) | (torch.arange(kmax, device=dev) == 0)
    notfix = (~fixed).to(torch.float32)[:, None]
    fixf = fixed.to(torch.float32)[:, None]
    oi, oj = fac.odo_i.long(), fac.odo_j.long()
    fi, fj = fac.obs_i.long(), fac.obs_j.long()
    wo = fac.odo_w * fac.odo_active.to(torch.float32)[:, None]
    wv = fac.obs_w * fac.obs_active.to(torch.float32)[:, None]
    lm_damp = (damping + (~lm_active).to(torch.float32))[:, None, None] * eye2
    poses, lms = poses0, lms0
    for _ in range(iters):
        # --- this rank's factors, linearised
        xi, xj = poses[oi], poses[oj]
        ji, jj = _edge_jacobians(xi, xj)
        ro = _odo_residual(xi, xj, fac.odo_z)
        h_ii = torch.einsum("eab,ea,eac->ebc", ji, wo, ji)      # (E, 3, 3)
        h_jj = torch.einsum("eab,ea,eac->ebc", jj, wo, jj)
        h_ij = torch.einsum("eab,ea,eac->ebc", ji, wo, jj)
        b_i = torch.einsum("eab,ea,ea->eb", ji, wo, ro)
        b_j = torch.einsum("eab,ea,ea->eb", jj, wo, ro)
        xo, lo = poses[fi], lms[fj]
        jp, jl = _obs_jacobians(xo, lo)
        rv = _obs_residual(xo, lo, fac.obs_z)
        hpp_o = torch.einsum("fab,fa,fac->fbc", jp, wv, jp)     # (F, 3, 3)
        hll_o = torch.einsum("fab,fa,fac->fbc", jl, wv, jl)     # (F, 2, 2)
        hpl_o = torch.einsum("fab,fa,fac->fbc", jp, wv, jl)     # (F, 3, 2)
        bp_o = torch.einsum("fab,fa,fa->fb", jp, wv, rv)
        bl_o = torch.einsum("fab,fa,fa->fb", jl, wv, rv)

        # --- the small systems, K- and L-shaped, completed over the ranks
        bp = psum((kmax, 3), torch.cat([oi, oj, fi]),
                  torch.cat([b_i, b_j, bp_o]))
        hll = psum((lmax, 2, 2), fj, hll_o) + lm_damp
        bl = psum((lmax, 2), fj, bl_o)
        hll_inv = _inv2(hll)

        # --- reduced RHS b_red = bp - U^T Hll^-1 bl, factor by factor
        zb = torch.einsum("lab,lb->la", hll_inv, bl)
        corr = psum((kmax, 3), fi, torch.einsum("fab,fb->fa", hpl_o,
                                                zb[fj]))
        rhs = -(bp - corr) * notfix

        # --- block-Jacobi preconditioner: exact Hpp diagonal blocks less
        # the factor-wise Schur diagonal correction
        sdiag = torch.einsum("fab,fbc,fdc->fad", hpl_o, hll_inv[fj], hpl_o)
        dpp = psum((kmax, 3, 3), torch.cat([oi, oj, fi, fi]),
                   torch.cat([h_ii, h_jj, hpp_o, -sdiag]))
        dblocks = torch.where(fixed[:, None, None], eye3,
                              dpp + damping * eye3)
        minv, _ = torch.linalg.inv_ex(dblocks)

        def matvec(v):
            """S v factor by factor; v and the result replicated (K, 3)."""
            vm = v * notfix
            y = psum((kmax, 3), torch.cat([oi, oj, fi]), torch.cat([
                torch.einsum("eab,eb->ea", h_ii, vm[oi])
                + torch.einsum("eab,eb->ea", h_ij, vm[oj]),
                torch.einsum("eba,eb->ea", h_ij, vm[oi])
                + torch.einsum("eab,eb->ea", h_jj, vm[oj]),
                torch.einsum("fab,fb->fa", hpp_o, vm[fi])]))
            # the Schur term: U spans ranks, so U^T vm is summed before
            # Hll^-1
            yl = psum((lmax, 2), fj, torch.einsum("fba,fb->fa", hpl_o,
                                                  vm[fi]))
            zl = torch.einsum("lab,lb->la", hll_inv, yl)
            y = y - psum((kmax, 3), fi, torch.einsum("fab,fb->fa", hpl_o,
                                                     zl[fj]))
            return y * notfix + v * fixf + damping * vm

        def precond(r):
            return torch.einsum("kab,kb->ka", minv, r)

        # --- PCG on S dp = rhs, no host sync
        x = torch.zeros_like(rhs)
        r = rhs
        z = precond(r)
        pvec = z
        rz = _sum64(r * z)
        for _ in range(cg_iters):
            ap = matvec(pvec)
            den = _sum64(pvec * ap)
            alpha = torch.where(den.abs() > 1e-20, rz / den,
                                torch.zeros_like(den))
            x = x + alpha * pvec
            r = r - alpha * ap
            z = precond(r)
            rz_new = _sum64(r * z)
            beta = torch.where(rz.abs() > 1e-20, rz_new / rz,
                               torch.zeros_like(rz))
            pvec = z + beta * pvec
            rz = rz_new
        dp = x * notfix

        # --- landmark back-substitution (replicated, 2x2 blocks)
        hlp_dp = psum((lmax, 2), fj, torch.einsum("fba,fb->fa", hpl_o,
                                                  dp[fi]))
        dl = torch.einsum("lab,lb->la", hll_inv, -bl - hlp_dp)
        dl = dl * lm_active.to(torch.float32)[:, None]
        new = poses + dp
        poses = torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], dim=1)
        lms = lms + dl
    return poses, lms


def optimize_ba_sharded(p: BAProblem, axis: Axis | None = None,
                        iters: int = 10, damping: float = 1e-3,
                        cg_iters: int | None = None) -> BAProblem:
    """Distributed damped Gauss-Newton with Schur landmark elimination, a
    drop-in for ``models.ba.optimize_ba``, every rank of ``axis`` (default:
    a "graph" mesh over the world) calling it with the whole problem.
    ``cg_iters`` defaults to three times the padded pose count (an exact
    solve in exact arithmetic); the block-Jacobi preconditioner makes a few
    dozen enough at scale. Returns the problem with the optimised poses and
    landmarks, the same on every rank."""
    if axis is None:
        axis = make_graph_mesh(p.poses.device.type)
    pp = pad_problem(p, axis.size)
    if cg_iters is None:
        cg_iters = 3 * pp.poses.shape[0]
    fac = pp._replace(**{f: axis.rows(getattr(pp, f)) for f in (
        "odo_i", "odo_j", "odo_z", "odo_w", "odo_active",
        "obs_i", "obs_j", "obs_z", "obs_w", "obs_active")})
    with _true_f32():
        poses, lms = _solve(pp.poses, pp.landmarks, pp.pose_active,
                            pp.lm_active, fac, _Scatter(axis), int(iters),
                            int(cg_iters), float(damping))
    return p._replace(poses=poses[:p.poses.shape[0]],
                      landmarks=lms[:p.landmarks.shape[0]])


def optimize_job(p: BAProblem, iters: int, cg_iters: int | None = None,
                 device_type: str = "cuda"):
    """``optimize_ba_sharded`` on a new graph mesh over the whole world: a
    job for ``multihost.launch`` (``p`` as numpy fields). Returns (poses,
    landmarks)."""
    prob = BAProblem(*(torch.as_tensor(v, device=device_type) for v in p))
    out = optimize_ba_sharded(prob, make_graph_mesh(device_type), iters,
                              cg_iters=cg_iters)
    return out.poses, out.landmarks
