"""Landmark bundle adjustment with Schur-complement reduction (counterpart
of ``lidar_slam_tpu.models.ba``).

Poses (K, 3) and landmarks (L, 2) are optimized jointly over odometry
factors (the pose graph's residual) and range/bearing observation factors,
one damped Gauss-Newton iteration at a time, by eliminating the landmarks:

    S  = Hpp - Hpl Hll^-1 Hlp          (reduced pose system)
    dp = solve(S, bp - Hpl Hll^-1 bl)
    dl = Hll^-1 (bl - Hlp dp)          (back-substitution)

``Hll`` is block-diagonal 2x2, so its inverse is closed-form. The JAX
package takes the factor Jacobians with ``jacfwd``; here they are written in
closed form. The blocks ``hpp``, ``bp``, ``hll``, ``bl`` and the (L, K, 3, 2)
``u`` of ``Hpl`` are scatter-added in float64 and rounded to float32 once,
so two runs on the card assemble the same system (a CUDA scatter-add sums in
an order that changes from run to run). The Schur correction is a plain f32
product (``einsum``), TF32 off; the reduced (3K, 3K) system is solved with
``solve_ex``, which leaves the error check on the device. No step of an
iteration waits for the host.

``optimize_ba`` is the counterpart of JAX's jitted ``fori_loop``: its body,
one iteration, as a CUDA graph per problem shape (``utils/graphs``),
captured with TF32 off and replayed once an iteration;
``optimize_ba_eager`` runs the same iterations op by op, the reference the
captured one is held to.

Observation convention as in ``models/ekf_slam.py``: reference-convention
poses, z = (range, bearing) with bearing = atan2(dy, dx) + theta.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from lidar_slam_tpu_torch.core import se2
from lidar_slam_tpu_torch.device import rounded64
from lidar_slam_tpu_torch.models.posegraph import (_edge_jacobians,
                                                   _edge_residual)
from lidar_slam_tpu_torch.utils import graphs


class BAProblem(NamedTuple):
    poses: torch.Tensor        # (K, 3) initial pose estimates
    landmarks: torch.Tensor    # (L, 2) initial landmark estimates
    pose_active: torch.Tensor  # (K,) bool
    lm_active: torch.Tensor    # (L,) bool
    # odometry factors (pose i -> pose j, measurement in standard convention)
    odo_i: torch.Tensor        # (E,) i32
    odo_j: torch.Tensor        # (E,) i32
    odo_z: torch.Tensor        # (E, 3)
    odo_w: torch.Tensor        # (E, 3)
    odo_active: torch.Tensor   # (E,) bool
    # observation factors (pose i observes landmark j)
    obs_i: torch.Tensor        # (F,) i32
    obs_j: torch.Tensor        # (F,) i32
    obs_z: torch.Tensor        # (F, 2) (range, bearing)
    obs_w: torch.Tensor        # (F, 2) diagonal information
    obs_active: torch.Tensor   # (F,) bool


def _obs_residual(pose: torch.Tensor, lm: torch.Tensor, z: torch.Tensor
                  ) -> torch.Tensor:
    """(range - z0, wrap(bearing - z1)), batched over a leading axis."""
    dx = lm[..., 0] - pose[..., 0]
    dy = lm[..., 1] - pose[..., 1]
    r = rounded64(torch.sqrt, torch.clamp(dx * dx + dy * dy, min=1e-12))
    bearing = torch.atan2(dy, dx) + pose[..., 2]
    return torch.stack([r - z[..., 0], se2.wrap_angle(bearing - z[..., 1])],
                       dim=-1)


def _obs_jacobians(pose: torch.Tensor, lm: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """d residual / d pose (F, 2, 3) and d residual / d landmark (F, 2, 2),
    in closed form (the bearing wrap has unit slope)."""
    dx = lm[:, 0] - pose[:, 0]
    dy = lm[:, 1] - pose[:, 1]
    q = dx * dx + dy * dy
    r = rounded64(torch.sqrt, torch.clamp(q, min=1e-12))
    drx, dry = dx / r, dy / r       # d range / d landmark
    dbx, dby = -dy / q, dx / q      # d bearing / d landmark
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    jp = torch.stack([torch.stack([-drx, -dry, zero], -1),
                      torch.stack([-dbx, -dby, one], -1)], dim=1)
    jl = torch.stack([torch.stack([drx, dry], -1),
                      torch.stack([dbx, dby], -1)], dim=1)
    return jp, jl


# the odometry factor is the pose graph's edge: between(xi, xj) - z, heading
# wrapped
_odo_residual = _edge_residual


def _inv2(m: torch.Tensor) -> torch.Tensor:
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = torch.clamp(a * d - b * c, min=1e-12)
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)],
                      -2)
    return inv / det[..., None, None]


@contextlib.contextmanager
def _true_f32():
    """TF32 off for the duration (restored after): the Schur product must
    round like the JAX package's f32 einsum, not through 10-bit mantissas."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _scatter64(shape, index, values: torch.Tensor) -> torch.Tensor:
    """Zeros of ``shape`` with ``values`` added at ``index``, summed in
    float64 and rounded to f32 once."""
    out = torch.zeros(shape, dtype=torch.float64, device=values.device)
    out.index_put_(index, values.to(torch.float64), accumulate=True)
    return out.to(torch.float32)


def optimize_ba_eager(p: BAProblem, iters: int = 10, damping: float = 1e-3
                      ) -> BAProblem:
    """Damped Gauss-Newton with Schur-complement landmark elimination, op
    by op."""
    poses, lms = p.poses, p.landmarks
    with _true_f32():
        for _ in range(iters):
            poses, lms = _gn_step(p, poses, lms, damping)
    return p._replace(poses=poses, landmarks=lms)


def _gn_step(p: BAProblem, poses: torch.Tensor, lms: torch.Tensor,
             damping: float) -> tuple[torch.Tensor, torch.Tensor]:
    """One Gauss-Newton iteration of ``p`` from ``poses`` and ``lms``
    (TF32 off, the caller's context): the new poses and landmarks."""
    kmax, lmax = p.poses.shape[0], p.landmarks.shape[0]
    dev = p.poses.device
    oi, oj = p.odo_i.long(), p.odo_j.long()
    fi, fj = p.obs_i.long(), p.obs_j.long()
    wo = p.odo_w * p.odo_active.to(torch.float32)[:, None]
    wv = p.obs_w * p.obs_active.to(torch.float32)[:, None]
    lm_damp = (damping + (~p.lm_active).to(torch.float32))[:, None, None] \
        * torch.eye(2, dtype=torch.float32, device=dev)
    diag = torch.arange(3 * kmax, device=dev)
    extra = (torch.where(diag < 3, 1e6, 0.0)
             + (~p.pose_active).to(torch.float32)[:, None].expand(
                 kmax, 3).reshape(-1) + damping)
    pose_on = p.pose_active.to(torch.float32)[:, None]
    lm_on = p.lm_active.to(torch.float32)[:, None]
    # odometry factor blocks (as in posegraph.optimize)
    xi, xj = poses[oi], poses[oj]
    ji, jj = _edge_jacobians(xi, xj)
    ro = _odo_residual(xi, xj, p.odo_z)
    h_ii = torch.einsum("eab,ea,eac->ebc", ji, wo, ji)
    h_jj = torch.einsum("eab,ea,eac->ebc", jj, wo, jj)
    h_ij = torch.einsum("eab,ea,eac->ebc", ji, wo, jj)
    b_i = torch.einsum("eab,ea,ea->eb", ji, wo, ro)
    b_j = torch.einsum("eab,ea,ea->eb", jj, wo, ro)

    # observation factor blocks
    xo, lo = poses[fi], lms[fj]
    jp, jl = _obs_jacobians(xo, lo)
    rv = _obs_residual(xo, lo, p.obs_z)
    hpp_o = torch.einsum("fab,fa,fac->fbc", jp, wv, jp)   # (F,3,3)
    hll_o = torch.einsum("fab,fa,fac->fbc", jl, wv, jl)   # (F,2,2)
    hpl_o = torch.einsum("fab,fa,fac->fbc", jp, wv, jl)   # (F,3,2)
    bp_o = torch.einsum("fab,fa,fa->fb", jp, wv, rv)      # (F,3)
    bl_o = torch.einsum("fab,fa,fa->fb", jl, wv, rv)      # (F,2)

    hpp = _scatter64(
        (kmax, kmax, 3, 3),
        (torch.cat([oi, oj, oi, oj, fi]),
         torch.cat([oi, oj, oj, oi, fi])),
        torch.cat([h_ii, h_jj, h_ij, h_ij.transpose(1, 2), hpp_o]))
    bp = _scatter64((kmax, 3), (torch.cat([oi, oj, fi]),),
                    torch.cat([b_i, b_j, bp_o]))
    hll = _scatter64((lmax, 2, 2), (fj,), hll_o) + lm_damp
    bl = _scatter64((lmax, 2), (fj,), bl_o)
    hll_inv = _inv2(hll)                                  # (L,2,2)

    # Schur complement: Hpl's nonzero (pose, landmark) blocks in U
    # (L, K, 3, 2); the correction folds over the landmark axis
    u = _scatter64((lmax, kmax, 3, 2), (fj, fi), hpl_o)
    s_corr = torch.einsum("lkab,lbc,lmdc->kmad", u, hll_inv, u)
    bp_corr = torch.einsum("lkab,lbc,lc->ka", u, hll_inv, bl)

    s = (hpp - s_corr).permute(0, 2, 1, 3).reshape(3 * kmax,
                                                   3 * kmax)
    s = s + torch.diag(extra)
    dp, _ = torch.linalg.solve_ex(s, -(bp - bp_corr).reshape(-1))
    dp = dp.reshape(kmax, 3) * pose_on
    # back-substitute landmarks: dl = Hll^-1 (-bl - Hlp dp)
    hlp_dp = torch.einsum("lkba,kb->la", u, dp)
    dl = torch.einsum("lab,lb->la", hll_inv, -bl - hlp_dp) * lm_on

    new = poses + dp
    poses = torch.cat([new[:, :2], se2.wrap_angle(new[:, 2:3])], 1)
    lms = lms + dl
    return poses, lms


class _OptimizeBaFn:
    """``optimize_ba_eager`` over a static copy of one problem shape: one
    Gauss-Newton iteration captured per ``damping`` (TF32 off in the
    warm-up and the capture), replayed once an iteration over the static
    poses and landmarks ``out``."""

    def __init__(self, p: BAProblem):
        self.problem = graphs.clone_tree(p)
        self.out = (torch.zeros_like(p.poses), torch.zeros_like(p.landmarks))
        self.graphs = graphs.Graphs(p.poses.device)

    def __call__(self, p: BAProblem, iters: int, damping: float
                 ) -> BAProblem:
        graphs.copy_into(self.problem, p)
        graphs.copy_into(self.out, (self.problem.poses,
                                    self.problem.landmarks))

        def body(bufs) -> None:
            problem, (poses, lms) = bufs
            with _true_f32():
                graphs.copy_into((poses, lms),
                                 _gn_step(problem, poses, lms, damping))

        for _ in range(iters):
            self.graphs.run(damping, body, (self.problem, self.out))
        return p._replace(poses=self.out[0].clone(),
                          landmarks=self.out[1].clone())


_OPTIMIZE_BA_FNS: dict = {}   # (device, leaf shapes and dtypes) -> fn


def optimize_ba(p: BAProblem, iters: int = 10, damping: float = 1e-3
                ) -> BAProblem:
    """Damped Gauss-Newton with Schur-complement landmark elimination, as a
    CUDA graph replay on the card (the same iterations as
    ``optimize_ba_eager``, bit for bit). A problem shape's graphs and
    buffers are made at its first call and kept for the process; the
    result's tensors are the caller's own."""
    key = (p.poses.device, tuple((tuple(t.shape), t.dtype) for t in p))
    fn = _OPTIMIZE_BA_FNS.get(key)
    if fn is None:
        fn = _OPTIMIZE_BA_FNS[key] = _OptimizeBaFn(p)
    return fn(p, iters, damping)


def ba_error(p: BAProblem) -> torch.Tensor:
    """Total weighted squared residual over the active factors, summed in
    float64 and rounded once."""
    oi, oj = p.odo_i.long(), p.odo_j.long()
    ro = _odo_residual(p.poses[oi], p.poses[oj], p.odo_z)
    rv = _obs_residual(p.poses[p.obs_i.long()], p.landmarks[p.obs_j.long()],
                       p.obs_z)
    f64 = torch.float64
    odo = (p.odo_w * ro * ro).to(f64) * p.odo_active.to(f64)[:, None]
    obs = (p.obs_w * rv * rv).to(f64) * p.obs_active.to(f64)[:, None]
    return (odo.sum() + obs.sum()).to(torch.float32)

