"""FastSLAM with per-particle landmark EKFs (counterpart of
``lidar_slam_tpu.models.ekf_slam``).

Each particle carries a bank of L 2-D landmark EKFs (mean and covariance).
A step updates every (particle, landmark) pair at once as batched 2x2
algebra with closed-form inverses, selects {update, initialize, keep} with
masks and resamples under an ESS gate. Two association modes:

- ``ekf_slam_step``: known association (simulator-fed observations, one
  row per landmark);
- ``ekf_slam_step_ml``: per-particle maximum-likelihood association of
  unordered detections (``ops/landmarks``), after a damped Gauss-Newton
  refinement of every particle's proposal pose against its associated
  landmarks; detections are processed in order, each one against all
  (particle, landmark) pairs.

The 2x2 and 3x3 algebra stays elementwise (``_mm2``, ``_mv2``, the
adjugate solve), never a matmul: the covariances feed the next step's gains
for a thousand steps, and a reduced-precision matmul path (bf16 on a TPU,
TF32 on a GPU) turns that into trajectory error.

JAX's ``lax.scan`` over scans becomes a Python loop; its ``lax.scan`` over
the M detection rows under a mask loops over the valid rows only (an
invalid row of JAX's changes nothing). The eager step takes them from the
host: each scan's count of compacted detections, or the valid rows found
on the host. The captured step (``n_det=DEVICE_LOOP``) orders the valid
rows first on the card and loops over their count with
``graphs.while_loop``, one CUDA graph WHILE node, so one graph serves every
count and the host never reads one. The resampling decision is a
device-side ``where``. ``run_ml`` and ``run_ekf_slam`` (JAX's jitted
``_run_ml_jit`` / ``_run_jit``) drive ``EkfStepFn``, the steps as one CUDA
graph over static buffers (``utils/graphs``).

Random numbers come from the ``torch.Generator`` in the state; the steps
take ``draws=(noise (P, 3) standard normal, u0 in [0, 1/P))`` from outside
instead, so the CPU and the card, or the port and the JAX package, can be
run on the same draws. Reductions over particles (softmax, CDF, weighted
means) and over landmarks and detections are float64 rounded once, and
cos, sin, atan2, log and sqrt are float64 rounded once (the card's f32
``torch.sqrt`` is not correctly rounded: about 0.7% of values differ from
the CPU's by an ulp), so the CPU and CUDA paths compute the same f32 values
from the same draws.

Conventions: poses use the reference convention (w = A(theta) p + t,
A = [[c, s], [-s, c]]); a landmark at world offset (dx, dy) is observed at
range |d| and sensor-frame bearing atan2(dy, dx) + theta.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch

from lidar_slam_tpu_torch.core import se2
from lidar_slam_tpu_torch.device import constant, resolve_device, rounded64
from lidar_slam_tpu_torch.models.fastslam import (ALL_ROWS, AllRows,
                                                  _softmax64,
                                                  effective_sample_size,
                                                  stage_draws, step_draws,
                                                  systematic_resample)
from lidar_slam_tpu_torch.utils import graphs


class EkfSlamConfig(NamedTuple):
    """The JAX package's fields and defaults (their rationale is documented
    there)."""

    n_particles: int = 1024
    max_landmarks: int = 16
    r_noise: float = 0.05       # measurement std (range, m)
    b_noise: float = 0.015      # measurement std (bearing, rad)
    odo_xy_noise: float = 0.006  # proposal noise around odometry
    odo_th_noise: float = 0.002
    resample_threshold: float = 0.5
    new_lm_logp0: float = -7.0   # log pseudo-likelihood of a new landmark
    use_scan_odometry: bool = False  # motion prior from the scan-to-scan
    #                              matcher pre-pass instead of constant
    #                              velocity
    r_noise_per_m: float = 0.0   # range-proportional measurement std growth


def long_tour_config(n_particles: int = 1024) -> EkfSlamConfig:
    """The tuned scan-driven config of the JAX package: range-scaled
    measurement noise, a wide proposal and late resampling."""
    return EkfSlamConfig(
        n_particles=n_particles, max_landmarks=64, r_noise=0.02,
        r_noise_per_m=0.015, b_noise=0.008, odo_xy_noise=0.02,
        odo_th_noise=0.02, new_lm_logp0=-11.0, resample_threshold=0.25,
        use_scan_odometry=True)


LONG_TOUR_MAX_RANGE = 12.0  # detection gating range pairing with the config


# the leaves with a leading particle axis (the rest is replicated)
PARTICLE_LEAVES = ("poses", "prev_poses", "logw", "lm_mean", "lm_cov",
                   "lm_seen")


class EkfSlamState(NamedTuple):
    poses: torch.Tensor       # (P, 3)
    prev_poses: torch.Tensor  # (P, 3) constant-velocity memory
    logw: torch.Tensor        # (P,)
    lm_mean: torch.Tensor     # (P, L, 2)
    lm_cov: torch.Tensor      # (P, L, 2, 2)
    lm_seen: torch.Tensor     # (P, L) bool
    rng: torch.Generator      # on the state's device


def init_ekf_slam(cfg: EkfSlamConfig, seed: int = 0,
                  device: str | torch.device = "cuda") -> EkfSlamState:
    dev = resolve_device(device)
    p, l = cfg.n_particles, cfg.max_landmarks
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    return EkfSlamState(
        poses=torch.zeros((p, 3), **f32),
        prev_poses=torch.zeros((p, 3), **f32),
        logw=torch.zeros(p, **f32),
        lm_mean=torch.zeros((p, l, 2), **f32),
        lm_cov=(torch.eye(2, **f32) * 1e4).repeat(p, l, 1, 1),
        lm_seen=torch.zeros((p, l), dtype=torch.bool, device=dev),
        rng=rng)


def _cos_sin(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return rounded64(torch.cos, a), rounded64(torch.sin, a)


def _sum64(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A sum whose order cannot change the rounded f32 result."""
    return x.to(torch.float64).sum(dim=dim).to(torch.float32)


def _weighted_mean(logw: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """softmax(logw)-weighted mean of poses (P, 3), float64 rounded once."""
    w = _softmax64(logw)
    return torch.sum(w[:, None] * poses.to(torch.float64),
                     dim=0).to(torch.float32)


def _compose_ref(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Compose in the reference convention: ``delta`` applied in ``pose``'s
    frame."""
    c, s = _cos_sin(pose[..., 2])
    x = pose[..., 0] + c * delta[..., 0] + s * delta[..., 1]
    y = pose[..., 1] - s * delta[..., 0] + c * delta[..., 1]
    return torch.stack([x, y, pose[..., 2] + delta[..., 2]], dim=-1)


def _inv2(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Closed-form 2x2 inverse and determinant (batched)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None], det


def _mm2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 @ 2x2 as elementwise f32 math (broadcasts like ``@``)."""
    a00, a01 = a[..., 0, 0], a[..., 0, 1]
    a10, a11 = a[..., 1, 0], a[..., 1, 1]
    b00, b01 = b[..., 0, 0], b[..., 0, 1]
    b10, b11 = b[..., 1, 0], b[..., 1, 1]
    return torch.stack([
        torch.stack([a00 * b00 + a01 * b10, a00 * b01 + a01 * b11], -1),
        torch.stack([a10 * b00 + a11 * b10, a10 * b01 + a11 * b11], -1)], -2)


def _mv2(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched 2x2 @ 2-vector, elementwise (see ``_mm2``)."""
    return torch.stack([m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1],
                        m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1]],
                       -1)


def _t(m: torch.Tensor) -> torch.Tensor:
    return m.transpose(-1, -2)


def _meas_cov(r_noise2, b_noise2: float, dev) -> torch.Tensor:
    """[[r_noise2, 0], [0, b_noise2]]: a cached constant for a float
    ``r_noise2``, device arithmetic (exact: products by 1 and 0, sums with
    0) for a 0-dim tensor, so no step copies a fresh tensor to the card."""
    if not isinstance(r_noise2, torch.Tensor):
        return constant(((r_noise2, 0.0), (0.0, b_noise2)), dev)
    return (r_noise2 * constant(((1.0, 0.0), (0.0, 0.0)), dev)
            + constant(((0.0, 0.0), (0.0, b_noise2)), dev))


_LOG_2PI_X2 = float(np.float32(2.0) * np.log(np.float32(2.0 * np.pi)))


def _gaussian_loglik(nu: torch.Tensor, s_inv: torch.Tensor,
                     s_det: torch.Tensor) -> torch.Tensor:
    return -0.5 * (torch.sum(nu * _mv2(s_inv, nu), -1)
                   + rounded64(torch.log, torch.clamp(s_det, min=1e-12))
                   + _LOG_2PI_X2)


def _innovation(lm_mean, poses, zr, zb):
    """Offsets, ranges and innovations of every (particle, landmark) pair:
    dx, dy, r2, r (P, L), nu (P, L, 2) and H = d(h)/d(landmark)."""
    px, py, pth = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]
    dx = lm_mean[..., 0] - px
    dy = lm_mean[..., 1] - py
    r2 = torch.clamp(dx * dx + dy * dy, min=1e-6)
    r = rounded64(torch.sqrt, r2)
    nu_r = zr - r
    nu_b = se2.wrap_angle(zb - (rounded64(torch.atan2, dy, dx) + pth))
    h = torch.stack([torch.stack([dx / r, dy / r], -1),
                     torch.stack([-dy / r2, dx / r2], -1)], dim=-2)
    return torch.stack([nu_r, nu_b], dim=-1), h


def _ekf_update(lm_mean, lm_cov, nu, h, meas_cov):
    """EKF update of every pair: updated means, covariances and the
    innovation log-likelihood."""
    hp = _mm2(h, lm_cov)
    s_mat = _mm2(hp, _t(h)) + meas_cov
    s_inv, s_det = _inv2(s_mat)
    k_gain = _mm2(_t(hp), s_inv)                      # P H^T S^-1
    return (lm_mean + _mv2(k_gain, nu), lm_cov - _mm2(k_gain, hp),
            _gaussian_loglik(nu, s_inv, s_det))


def _init_landmark(poses_xy, pth, zr, zb, meas_cov):
    """First sighting: mean and covariance of the landmark from the pose."""
    ang = zb - pth                                    # world angle
    c, s = _cos_sin(ang)
    mean = torch.stack([poses_xy[0] + zr * c, poses_xy[1] + zr * s], dim=-1)
    jac = torch.stack([torch.stack([c, -zr * s], -1),
                       torch.stack([s, zr * c], -1)], dim=-2)
    return mean, _mm2(_mm2(jac, meas_cov), _t(jac))


def _resample(state: EkfSlamState, poses, logw, u0, cfg: EkfSlamConfig,
              banks, rows: AllRows = ALL_ROWS):
    """The ESS-gated systematic resampling shared by both steps: ancestors
    carry their landmark banks. ``logw`` holds every particle, ``poses`` and
    ``banks`` this block's rows (all of them unsharded). Returns (every
    particle's poses and logw, this block's prev_poses and banks)."""
    p = cfg.n_particles
    do_rs = effective_sample_size(logw) < cfg.resample_threshold * p
    idx = torch.where(do_rs, systematic_resample(u0, logw),
                      torch.arange(p, device=poses.device))
    mine = rows.rows(idx)
    prev = torch.where(do_rs, rows.gather(state.poses)[mine], state.poses)
    logw = torch.where(do_rs, torch.zeros_like(logw), logw)
    return (rows.gather(poses)[idx], prev, logw,
            [rows.gather(b)[mine] for b in banks])


def ekf_slam_step(state: EkfSlamState, odo: torch.Tensor, obs: torch.Tensor,
                  vis: torch.Tensor, cfg: EkfSlamConfig, draws=None
                  ) -> tuple[EkfSlamState, torch.Tensor]:
    """Known association: propagate through ``odo`` (3,), update every
    (particle, landmark) pair with ``obs`` (L, 2) where ``vis`` (L,), then
    resample. Returns (state, estimated pose)."""
    dev = state.poses.device
    noise, u0 = step_draws(state, draws, cfg.n_particles)
    sigma = constant((cfg.odo_xy_noise, cfg.odo_xy_noise, cfg.odo_th_noise),
                     dev)
    poses = _compose_ref(state.poses, odo[None, :] + noise * sigma)

    zr, zb = obs[None, :, 0], obs[None, :, 1]                 # (1, L)
    meas_cov = _meas_cov(float(np.float32(cfg.r_noise ** 2)),
                         float(np.float32(cfg.b_noise ** 2)), dev)
    nu, h = _innovation(state.lm_mean, poses, zr, zb)
    upd_mean, upd_cov, loglik = _ekf_update(state.lm_mean, state.lm_cov, nu,
                                            h, meas_cov)
    init_mean, init_cov = _init_landmark(
        (poses[:, 0:1], poses[:, 1:2]), poses[:, 2:3], zr, zb, meas_cov)

    seen = state.lm_seen
    visb = vis[None, :]
    do_upd = (visb & seen)[..., None]
    do_init = (visb & ~seen)[..., None]
    new_mean = torch.where(do_upd, upd_mean,
                           torch.where(do_init, init_mean, state.lm_mean))
    new_cov = torch.where(do_upd[..., None], upd_cov,
                          torch.where(do_init[..., None], init_cov,
                                      state.lm_cov))
    logw = state.logw + _sum64(torch.where(visb & seen, loglik, 0.0), 1)
    logw = logw - logw.max()

    poses, prev, logw, (new_mean, new_cov, new_seen) = _resample(
        state, poses, logw, u0, cfg, [new_mean, new_cov, seen | visb])
    new_state = EkfSlamState(poses=poses, prev_poses=prev, logw=logw,
                             lm_mean=new_mean, lm_cov=new_cov,
                             lm_seen=new_seen, rng=state.rng)
    return new_state, _weighted_mean(logw, poses)


def _landmark_likelihoods(state: EkfSlamState, poses: torch.Tensor,
                          zr: torch.Tensor, zb: torch.Tensor,
                          cfg: EkfSlamConfig):
    """EKF math of ONE detection (0-dim zr, zb) against all (P, L) pairs.

    Returns (loglik (P, L), upd_mean (P, L, 2), upd_cov (P, L, 2, 2),
    init_mean (P, 2), init_cov (P, 2, 2))."""
    r_sig = float(np.float32(cfg.r_noise)) + float(
        np.float32(cfg.r_noise_per_m)) * zr
    meas_cov = _meas_cov(r_sig * r_sig, float(np.float32(cfg.b_noise ** 2)),
                         poses.device)
    nu, h = _innovation(state.lm_mean, poses, zr, zb)
    upd_mean, upd_cov, loglik = _ekf_update(state.lm_mean, state.lm_cov, nu,
                                            h, meas_cov)
    init_mean, init_cov = _init_landmark((poses[:, 0], poses[:, 1]),
                                         poses[:, 2], zr, zb, meas_cov)
    return loglik, upd_mean, upd_cov, init_mean, init_cov


_DAMP = (100.0, 100.0, 400.0)   # GN prior stiffness (x, y, theta)
_GN_CAP = (0.05, 0.05, 0.02)    # largest GN move a pass (x, y, theta)


def _gn_step(state: EkfSlamState, poses, zr_m, zb_m, dval_m, r_w_m, b_w,
             log_p0: float):
    """One damped Gauss-Newton pass of every particle's pose against its
    ML-associated landmarks (means held fixed), all M detections batched."""
    p = poses.shape[0]
    dev = poses.device
    px, py, pth = poses[:, 0:1], poses[:, 1:2], poses[:, 2:3]
    dx = state.lm_mean[..., 0] - px                   # (P, L)
    dy = state.lm_mean[..., 1] - py
    r2 = torch.clamp(dx * dx + dy * dy, min=1e-6)
    r = rounded64(torch.sqrt, r2)
    bearing = rounded64(torch.atan2, dy, dx) + pth
    nu_r = zr_m - r[None]                             # (M, P, L)
    nu_b = se2.wrap_angle(zb_m - bearing[None])
    ll = -0.5 * (nu_r * nu_r * r_w_m + nu_b * nu_b * b_w)
    ll = torch.where(state.lm_seen[None], ll, -torch.inf)
    ll_b, j = torch.max(ll, dim=2)                    # (M, P), first max
    take = (dval_m[:, None] & (ll_b > 2.0 * log_p0)
            & state.lm_seen.any(dim=1)[None])
    m = zr_m.shape[0]

    def at_j(v):                                      # (P, L) or (M, P, L)
        v = v.expand(m, p, v.shape[-1])
        return torch.gather(v, 2, j[..., None])[..., 0]

    dxj, dyj, rj, r2j = at_j(dx), at_j(dy), at_j(r), at_j(r2)
    nrj, nbj = at_j(nu_r), at_j(nu_b)
    zero, one = torch.zeros_like(rj), torch.ones_like(rj)
    h_r = torch.stack([-dxj / rj, -dyj / rj, zero], -1)   # (M, P, 3)
    h_b = torch.stack([dyj / r2j, -dxj / r2j, one], -1)
    w_r = take.to(torch.float32) * r_w_m[:, :, 0]          # (M, P)
    w_b = take.to(torch.float32) * b_w
    hth = (_sum64(w_r[..., None, None] * h_r[..., :, None]
                  * h_r[..., None, :], 0)
           + _sum64(w_b[..., None, None] * h_b[..., :, None]
                    * h_b[..., None, :], 0))               # (P, 3, 3)
    htn = (_sum64((w_r * nrj)[..., None] * h_r, 0)
           + _sum64((w_b * nbj)[..., None] * h_b, 0))      # (P, 3)
    # damped solve (H^T W H + lambda I) delta = H^T W nu by the explicit
    # symmetric-3x3 adjugate
    a = hth + torch.diag(constant(_DAMP, dev))[None]
    a00, a01, a02 = a[:, 0, 0], a[:, 0, 1], a[:, 0, 2]
    a11, a12, a22 = a[:, 1, 1], a[:, 1, 2], a[:, 2, 2]
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    inv_det = 1.0 / (a00 * c00 + a01 * c01 + a02 * c02)  # damp => det >> 0
    b0, b1, b2 = htn[:, 0], htn[:, 1], htn[:, 2]
    delta = torch.stack([
        (c00 * b0 + c01 * b1 + c02 * b2) * inv_det,
        (c01 * b0 + c11 * b1 + c12 * b2) * inv_det,
        (c02 * b0 + c12 * b1 + c22 * b2) * inv_det], dim=-1)
    cap = constant(_GN_CAP, dev)
    return poses + torch.clamp(delta, -cap, cap)


def _associate(state: EkfSlamState, poses, lm_mean, lm_cov, seen, zr, zb,
               cfg: EkfSlamConfig):
    """One detection, every particle: update its most likely landmark, or
    initialise a slot (the first free one; with the bank full, the one of
    largest covariance trace) when the best score is below
    ``new_lm_logp0``. Returns (lm_mean, lm_cov, seen, loglik add (P,))."""
    l = lm_mean.shape[1]
    log_p0 = float(np.float32(cfg.new_lm_logp0))
    loglik, upd_mean, upd_cov, init_mean, init_cov = _landmark_likelihoods(
        state._replace(lm_mean=lm_mean, lm_cov=lm_cov), poses, zr, zb, cfg)
    loglik = torch.where(seen, loglik, -torch.inf)
    best_ll, best = torch.max(loglik, dim=1)               # (P,)
    first_free = torch.argmin(seen.to(torch.uint8), dim=1)  # first False
    full = seen.all(dim=1)
    evict = torch.argmax(lm_cov[..., 0, 0] + lm_cov[..., 1, 1], dim=1)
    spawn_slot = torch.where(full, evict, first_free)
    make_new = best_ll < log_p0
    slot = torch.where(make_new, spawn_slot, best)
    sel = slot[:, None] == torch.arange(l, device=slot.device)[None, :]
    upd_sel = (sel & ~make_new[:, None])[..., None]
    new_sel = (sel & make_new[:, None])[..., None]
    lm_mean = torch.where(upd_sel, upd_mean,
                          torch.where(new_sel, init_mean[:, None, :], lm_mean))
    lm_cov = torch.where(upd_sel[..., None], upd_cov,
                         torch.where(new_sel[..., None],
                                     init_cov[:, None, :, :], lm_cov))
    add = torch.where(make_new, torch.full_like(best_ll, log_p0), best_ll)
    return lm_mean, lm_cov, seen | sel, add


# ``ekf_slam_step_ml``'s ``n_det`` for the association loop on the device
DEVICE_LOOP = "device loop"


def _associate_on_device(state: EkfSlamState, poses, obs, obs_valid,
                         cfg: EkfSlamConfig):
    """``_associate`` of every valid row of ``obs`` (M, 2) in row order, as
    ``graphs.while_loop`` over their device count: the rows are put in a
    stable order, valid rows first (``torch.nonzero(obs_valid)``'s order),
    and iteration k takes row ``order[k]`` by an index on the device.
    Returns (lm_mean, lm_cov, seen, loglik add (P,)), the eager loop's
    values bit for bit."""
    order = torch.argsort(torch.logical_not(obs_valid).to(torch.int32),
                          stable=True)
    count = obs_valid.sum()
    k = torch.zeros((), dtype=torch.int64, device=obs.device)
    go = count > k
    carry = (state.lm_mean.clone(), state.lm_cov.clone(),
             state.lm_seen.clone(), torch.zeros_like(state.logw))

    def body():
        row = obs.index_select(0, order.index_select(0, k.view(1)))[0]
        lm_mean, lm_cov, seen, add = _associate(
            state, poses, *carry[:3], row[0], row[1], cfg)
        graphs.copy_into(carry[:3], (lm_mean, lm_cov, seen))
        carry[3].add_(add)
        k.add_(1)
        torch.lt(k, count, out=go)

    graphs.while_loop(go, body)
    return carry


def ekf_slam_step_ml(state: EkfSlamState, obs: torch.Tensor,
                     obs_valid: torch.Tensor, cfg: EkfSlamConfig,
                     odo: torch.Tensor | None = None, aux_loglik_fn=None,
                     draws=None, n_det: int | None = None,
                     rows: AllRows = ALL_ROWS
                     ) -> tuple[EkfSlamState, torch.Tensor]:
    """FastSLAM 1.0 step with per-particle maximum-likelihood association
    of detections ``obs`` (M, 2) where ``obs_valid`` (M,).

    Particles propagate by ``odo`` (3,) in their own frames when
    ``cfg.use_scan_odometry`` (required then), else by their own constant
    velocity; two damped Gauss-Newton passes refine each proposal; the
    valid detections are then associated in order. ``aux_loglik_fn(poses
    (P, 3)) -> (P,)`` adds a per-particle log-likelihood before resampling
    (the hybrid's grid term). ``n_det`` is the number of valid rows when
    they are the first ones (compacted detections), or a tuple of the valid
    rows; without it the valid rows are found on the host; with
    ``DEVICE_LOOP`` they are found and looped over on the device
    (``_associate_on_device``, the captured steps' form). ``rows``
    (``fastslam.AllRows``): the state may hold one block of the particles
    (``parallel/sharded_ekf.py``); the max, the resampling and the weighted
    mean then run over every particle's gathered rows, so a sharded step
    equals the unsharded one."""
    dev = state.poses.device
    noise, u0 = step_draws(state, draws, cfg.n_particles, rows)
    sigma = constant((cfg.odo_xy_noise, cfg.odo_xy_noise, cfg.odo_th_noise),
                     dev)
    noise = noise * sigma
    if cfg.use_scan_odometry:
        if odo is None:
            raise ValueError(
                "cfg.use_scan_odometry=True requires an `odo` (3,) delta "
                "(see ops/scan_odometry.pairwise_odometry)")
        poses = _compose_ref(state.poses, odo[None, :] + noise)
    else:
        poses = state.poses + (state.poses - state.prev_poses) + noise

    log_p0 = float(np.float32(cfg.new_lm_logp0))
    zr_m = obs[:, 0][:, None, None]                   # (M, 1, 1)
    zb_m = obs[:, 1][:, None, None]
    r_sig_m = float(np.float32(cfg.r_noise)) + float(
        np.float32(cfg.r_noise_per_m)) * zr_m
    r_w_m = 1.0 / (r_sig_m * r_sig_m)
    b_w = float(np.float32(1.0 / cfg.b_noise ** 2))
    for _ in range(2):
        poses = _gn_step(state, poses, zr_m, zb_m, obs_valid, r_w_m, b_w,
                         log_p0)

    if n_det is DEVICE_LOOP:
        lm_mean, lm_cov, seen, logw_add = _associate_on_device(
            state, poses, obs, obs_valid, cfg)
    else:
        if n_det is None:
            dets = torch.nonzero(obs_valid).flatten().tolist()
        else:
            dets = range(n_det) if isinstance(n_det, int) else n_det
        lm_mean, lm_cov, seen = state.lm_mean, state.lm_cov, state.lm_seen
        logw_add = torch.zeros_like(state.logw)
        for k in dets:
            lm_mean, lm_cov, seen, add = _associate(
                state, poses, lm_mean, lm_cov, seen, obs[k, 0], obs[k, 1],
                cfg)
            logw_add = logw_add + add
    if aux_loglik_fn is not None:
        logw_add = logw_add + aux_loglik_fn(poses)
    logw = rows.gather(state.logw + logw_add)
    logw = logw - logw.max()

    poses, prev, logw, (lm_mean, lm_cov, seen) = _resample(
        state, poses, logw, u0, cfg, [lm_mean, lm_cov, seen], rows)
    new_state = EkfSlamState(poses=rows.rows(poses), prev_poses=prev,
                             logw=rows.rows(logw), lm_mean=lm_mean,
                             lm_cov=lm_cov, lm_seen=seen, rng=state.rng)
    return new_state, _weighted_mean(logw, poses)


class _Static(NamedTuple):
    """The captured EKF step's static buffers."""
    obs: torch.Tensor     # (M, 2) detections, or (L, 2) known observations
    valid: torch.Tensor   # (M,) / (L,) bool
    odo: torch.Tensor     # (3,)
    noise: torch.Tensor   # (P, 3) the step's proposal noise
    u0: torch.Tensor      # () the step's resampling offset
    state: EkfSlamState   # the step's state
    pose: torch.Tensor    # (3,) the step's estimate


class EkfStepFn(graphs.CapturedStep):
    """``step(state, obs, valid, odo, draws=None) -> (state, pose)``:
    ``ekf_slam_step_ml`` as one captured CUDA graph for every detection
    count (``graphs.CapturedStep`` has the conventions): the association
    loop over the valid rows of ``valid`` is a WHILE node
    (``DEVICE_LOOP``); with ``known`` one graph of ``ekf_slam_step``
    (``obs`` the (L, 2) observations, ``valid`` their visibility).

    A step draws its noise and offset with ``draw`` from the state's
    generator (or uploads ``draws``) into static buffers, as the eager step
    does, and replays its graph; every step is captured (there is no eager
    scan 1), and ``step`` reads nothing on the host: it returns the
    estimate ``pose`` on the device, the step's buffer (``self.pose`` is
    the same tensor). ``finish`` (the run's one read) books the
    association loop's iterations.

    ``rows`` is ``ekf_slam_step_ml``'s (``parallel/sharded_ekf.py``): a
    sharded step's collectives are captured in the main graph, none in the
    WHILE body, and booked once a replay."""

    key = None
    eager_first = False

    def __init__(self, cfg: EkfSlamConfig, device: str | torch.device = "cuda",
                 known: bool = False, rows: AllRows = ALL_ROWS):
        if known and rows is not ALL_ROWS:
            raise ValueError("the known-association step is not sharded")
        super().__init__(device, graphs.COUNTED + (
            () if rows is ALL_ROWS else (rows,)))
        self.cfg = cfg
        self.known = known
        self.rows = rows

    def __call__(self, state: EkfSlamState, obs: torch.Tensor,
                 valid: torch.Tensor, odo: torch.Tensor, draws=None
                 ) -> tuple[EkfSlamState, torch.Tensor]:
        return self._replay(state, obs, valid, odo, draws), self.pose

    def _alloc(self, state: EkfSlamState, obs, valid, *rest, **kw
               ) -> _Static:
        f32 = dict(dtype=torch.float32, device=self.device)
        return _Static(
            obs=torch.zeros(obs.shape, **f32),
            valid=torch.zeros(valid.shape, dtype=torch.bool,
                              device=self.device),
            odo=torch.zeros(3, **f32),
            noise=torch.zeros((self.cfg.n_particles, 3), **f32),
            u0=torch.zeros((), **f32), state=state,
            pose=torch.zeros(3, **f32))

    def _held(self) -> EkfSlamState:
        return self.bufs.state

    def _stage(self, state: EkfSlamState, obs, valid, odo,
               draws=None) -> None:
        b = self.bufs
        for buf, x in ((b.obs, obs), (b.valid, valid), (b.odo, odo)):
            buf.copy_(x, non_blocking=True)
        stage_draws(b, state, draws)

    def _returned(self, state: EkfSlamState):
        return self.bufs.state._replace(rng=state.rng), self.bufs.pose, None

    def _body(self, b: _Static) -> None:
        if self.known:
            new, pose = ekf_slam_step(b.state, b.odo, b.obs, b.valid,
                                      self.cfg, draws=(b.noise, b.u0))
        else:
            new, pose = ekf_slam_step_ml(
                b.state, b.obs, b.valid, self.cfg, odo=b.odo,
                draws=(b.noise, b.u0), n_det=DEVICE_LOOP, rows=self.rows)
        graphs.copy_into(b.state, new)
        b.pose.copy_(pose)


def run_ml(obs_all, valid_all, odo_all, cfg: EkfSlamConfig, seed: int = 0,
           device: str | torch.device = "cuda", draws=None, counts=None,
           rows: AllRows = ALL_ROWS, eager: bool = False
           ) -> tuple[torch.Tensor, EkfSlamState]:
    """The ML-association filter over scans 1..T-1: obs_all (T-1, M, 2),
    valid_all (T-1, M), odo_all (T-1, 3). ``draws`` a sequence of per-step
    (noise, u0). The steps run captured (``EkfStepFn``: the valid rows of
    each scan are found on the card) and the run reads the host once, at
    its end (``graphs.finish``). ``rows``: the particle block this process
    runs (the state holds its rows). With
    ``eager`` the steps are the eager ``ekf_slam_step_ml``, the captured
    run's reference, which take each scan's rows from the host: ``counts``
    (each row's detections, valid rows first), where given, else the
    masks, in one copy. Returns (path (T, 3) on ``device``, final
    state)."""
    dev = resolve_device(device)
    obs_all, valid_all, odo_all = (torch.as_tensor(a, device=dev)
                                   for a in (obs_all, valid_all, odo_all))
    obs_all = obs_all.to(torch.float32)
    odo_all = odo_all.to(torch.float32)
    state = init_ekf_slam(cfg, seed, dev)
    state = state._replace(**{f: rows.rows(getattr(state, f))
                              for f in PARTICLE_LEAVES})
    n = obs_all.shape[0]
    if not eager:
        return graphs.drive(
            EkfStepFn(cfg, dev, rows=rows), state, n + 1,
            lambda t: (obs_all[t - 1], valid_all[t - 1], odo_all[t - 1],
                       None if draws is None else draws[t - 1]))
    path = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)
    if counts is None:
        dets = [tuple(np.flatnonzero(v).tolist())
                for v in valid_all.cpu().numpy()]
    else:
        dets = torch.as_tensor(counts).tolist()
    for t in range(n):
        state, path[t + 1] = ekf_slam_step_ml(
            state, obs_all[t], valid_all[t], cfg, odo=odo_all[t],
            draws=None if draws is None else draws[t], n_det=dets[t],
            rows=rows)
    return path, state


def scan_inputs(ranges_all: np.ndarray, cfg: EkfSlamConfig, lidar_cfg=None,
                max_range: float = 18.0, include_pillars: bool = False,
                device: str | torch.device = "cuda", **extract_kw):
    """``run_ml``'s inputs from raw ranges (T, N): corner detections
    (``ops/landmarks``, one batch for the whole log; pillars too with
    ``include_pillars``) and, with ``cfg.use_scan_odometry``, the batched
    scan-to-scan matcher's motion prior (``ops/scan_odometry.
    pairwise_odometry``, kernel K1 on the (50, 448, 448) pair rasters on
    CUDA). Detections of scan t pair with the pose after step t-1. Returns
    (obs (T-1, M, 2), valid (T-1, M), odo (T-1, 3), counts (T-1,)), all on
    ``device``: the one read of the host is the motion prior's clip check
    (JAX's too)."""
    from lidar_slam_tpu_torch.config import LidarConfig
    from lidar_slam_tpu_torch.core.sensor import beam_angles
    from lidar_slam_tpu_torch.ops import landmarks as lm_ops
    from lidar_slam_tpu_torch.ops import scan_odometry

    dev = resolve_device(device)
    lidar_cfg = lidar_cfg or LidarConfig()
    ranges = torch.as_tensor(np.asarray(ranges_all, np.float32), device=dev)
    angles = torch.as_tensor(beam_angles(lidar_cfg), device=dev)
    common = dict(range_min=lidar_cfg.range_min,
                  usable_range=lidar_cfg.usable_range, max_range=max_range)
    if include_pillars:
        det = lm_ops.extract_landmarks_batch(ranges, angles, corners=True,
                                             **common, **extract_kw)
    else:
        det = lm_ops.extract_corners(ranges, angles, **common, **extract_kw)
    if cfg.use_scan_odometry:
        odo_all = scan_odometry.pairwise_odometry(ranges, angles, lidar_cfg)
        # 10%: corridor-ambiguity noise puts about 5% of a healthy museum
        # run's deltas on the boundary; fast motion saturates most of them
        frac = scan_odometry.reach_clip_fraction(odo_all.cpu().numpy())
        if frac > 0.10:
            warnings.warn(
                f"scan odometry: {frac:.1%} of pair deltas sit on the descent "
                "reach boundary (~+-0.06 m/rad) — per-scan motion likely "
                "exceeds the envelope and the motion prior is clipped; widen "
                "pairwise_odometry step_t0/step_r0", RuntimeWarning,
                stacklevel=3)
    else:
        odo_all = torch.zeros((ranges.shape[0] - 1, 3), dtype=torch.float32,
                              device=dev)
    return det.rb[1:], det.valid[1:], odo_all, det.count[1:]


def run_ekf_slam_scan(ranges_all: np.ndarray, cfg: EkfSlamConfig,
                      lidar_cfg=None, seed: int = 0, max_range: float = 18.0,
                      include_pillars: bool = False,
                      device: str | torch.device = "cuda", draws=None,
                      **extract_kw) -> tuple[torch.Tensor, EkfSlamState]:
    """Scan-driven EKF-FastSLAM: raw ranges (T, N) -> ``scan_inputs`` ->
    the ML-association filter. ``draws``: per-step (noise, u0) for steps
    1..T-1. Returns (path (T, 3) on ``device``, final state)."""
    dev = resolve_device(device)
    obs, valid, odo, _ = scan_inputs(ranges_all, cfg, lidar_cfg, max_range,
                                     include_pillars, dev, **extract_kw)
    return run_ml(obs, valid, odo, cfg, seed, dev, draws)


def run_ekf_slam(odom: np.ndarray, obs: np.ndarray, vis: np.ndarray,
                 cfg: EkfSlamConfig, seed: int = 0,
                 device: str | torch.device = "cuda", draws=None
                 ) -> tuple[torch.Tensor, EkfSlamState]:
    """Known-association run through ``EkfStepFn(known=True)``. obs (T, L,
    2) and vis (T, L) include t=0, which is skipped: obs[t] pairs with the
    pose after odom[t-1]. Returns (path (T, 3) on ``device``, final
    state)."""
    dev = resolve_device(device)
    odom = torch.as_tensor(np.asarray(odom, np.float32), device=dev)
    obs = torch.as_tensor(np.asarray(obs, np.float32), device=dev)
    vis = torch.as_tensor(np.asarray(vis, bool), device=dev)
    state = init_ekf_slam(cfg, seed, dev)
    return graphs.drive(
        EkfStepFn(cfg, dev, known=True), state, odom.shape[0] + 1,
        lambda t: (obs[t], vis[t], odom[t - 1],
                   None if draws is None else draws[t - 1]))


def landmark_estimates(state: EkfSlamState) -> np.ndarray:
    """Weight-averaged landmark means (L, 2), numpy."""
    w = _softmax64(state.logw)
    est = torch.einsum("p,plk->lk", w, state.lm_mean.to(torch.float64))
    return est.to(torch.float32).cpu().numpy()
