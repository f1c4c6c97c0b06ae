"""Scan-driven landmark extraction: pillar and corner detection on gated
beams (counterpart of ``lidar_slam_tpu.ops.landmarks``).

Every function takes ranges ``(..., N)``: a leading scan axis runs a whole
log in one batch, as ``jax.vmap`` does in the JAX package.

Detectors, as in the JAX package:

- pillars: the beam array is cut into segments at range discontinuities;
  a segment is a pillar when it is short, near and both neighbouring
  segments lie at least ``gap`` behind it;
- corners: lines are fitted to the k beams on each side of every beam
  (closed-form PCA from window sums); a corner is a beam whose two sides
  are straight, meet at more than ``min_angle`` and whose window is
  continuous; non-maximum suppression keeps one beam a corner, and the
  detection is the intersection of the two fitted lines.

The first ``max_out`` detections (beam order) are compacted into fixed
``(M, 2)`` range/bearing slots with a validity mask; JAX's
``.at[rank].set(mode="drop")`` becomes a scatter into one spare slot.

The thresholds are hard, so the CPU and the card must compute the same f32
values, and the corner detector must compute the JAX package's. Four
choices do it:

- cos, sin, atan2, hypot and sqrt are evaluated in float64 and rounded
  once (the libm differs between devices, and the card's f32 sqrt is not
  correctly rounded; in float64 the rounded f32 does not differ). The
  beam angles' cos and sin come out as XLA's, which folds them at compile
  time;
- the pillar segment sums are float64 ``index_add_``: a segment of valid
  beams sums values between 0.023 m and 24 m, exact in float64 in any
  order, so the card's atomics give the CPU's sums;
- the corner windows are differences of f32 prefix sums over the whole
  scan, as in the JAX package. Their cancellation error is about one f32
  ulp of the running total (about 1e-3 m^2 for x^2 on the museum), the
  size of ``max_resid``, so the detections near the thresholds depend on
  the rounding of every partial sum. ``cumsum32`` adds in the order of
  XLA:CPU's cumulative sum (sequential blocks of 16, the block totals
  scanned the same way, each block offset by the exclusive prefix of its
  level), one elementwise add at a time, so it is bit-identical to the JAX
  package's and the same on every device. Exact float64 window sums were
  tried first: they lose about 10% of the JAX package's corners on the
  museum tour (2704 against 3019), and change the filters' inputs;
- the window covariances are subtracted as XLA:CPU's fused multiply-adds
  (``_fms``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_slam_tpu_torch.device import rounded64

_FAR = 1e6
_ARC = 0.004363   # beam spacing (rad) of the arc-length width estimate


class LandmarkDetections(NamedTuple):
    rb: torch.Tensor     # (..., M, 2) f32 — (range, bearing), zero-padded
    valid: torch.Tensor  # (..., M) bool
    count: torch.Tensor  # (...) i32


def _shift(v: torch.Tensor, s: int, fill) -> torch.Tensor:
    """``v`` moved ``s`` beams along the last axis (``out[i] = v[i - s]``),
    ``fill`` where that falls off the array."""
    if s == 0:
        return v
    pad = torch.full(v.shape[:-1] + (abs(s),), fill, dtype=v.dtype,
                     device=v.device)
    if s > 0:
        return torch.cat([pad, v[..., :-s]], dim=-1)
    return torch.cat([v[..., -s:], pad], dim=-1)


def _compact(rb: torch.Tensor, keep: torch.Tensor, max_out: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows of ``rb`` (..., N, 2) where ``keep``, in order, in ``max_out``
    zero-padded slots, and their count (capped at ``max_out``)."""
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    slot = torch.where(keep & (rank < max_out), rank, max_out).to(torch.int64)
    out = torch.zeros(rb.shape[:-2] + (max_out + 1, 2), dtype=torch.float32,
                      device=rb.device)
    out.scatter_(-2, slot[..., None].expand(rb.shape), rb)
    count = torch.clamp(keep.sum(dim=-1), max=max_out).to(torch.int32)
    return out[..., :max_out, :], count


def _detections(rb, keep, max_out: int) -> LandmarkDetections:
    out, count = _compact(rb, keep, max_out)
    valid = torch.arange(max_out, device=rb.device) < count[..., None]
    return LandmarkDetections(rb=out, valid=valid, count=count)


def _polar(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(range, bearing) of sensor-frame points, stacked on a last axis."""
    return torch.stack([rounded64(torch.hypot, x, y),
                        rounded64(torch.atan2, y, x)], dim=-1)


def extract_landmarks(ranges: torch.Tensor, angles: torch.Tensor,
                      range_min: float = 0.023, usable_range: float = 24.0,
                      gap: float = 0.6, max_width: float = 1.0,
                      min_beams: int = 3, max_range: float = 12.0,
                      max_out: int = 16) -> LandmarkDetections:
    """Pillar-like clusters in scans (..., N)."""
    n = ranges.shape[-1]
    r = ranges.to(torch.float32)
    ok = (r >= range_min) & (r <= usable_range)
    # heal isolated dropouts whose two neighbours are valid and consistent
    prev_ok, next_ok = _shift(ok, 1, False), _shift(ok, -1, False)
    prev_rv = torch.cat([r[..., :1], r[..., :-1]], dim=-1)
    next_rv = torch.cat([r[..., 1:], r[..., -1:]], dim=-1)
    healable = (~ok) & prev_ok & next_ok & (torch.abs(prev_rv - next_rv) < gap)
    r = torch.where(healable, 0.5 * (prev_rv + next_rv), r)
    ok = ok | healable
    r_eff = torch.where(ok, r, _FAR)   # invalid beams are far background

    # --- segments at discontinuities, summed per segment in float64
    dr = torch.abs(r_eff[..., 1:] - r_eff[..., :-1])
    brk = torch.cat([torch.ones_like(dr[..., :1], dtype=torch.bool),
                     dr > gap], dim=-1)
    seg = torch.cumsum(brk.to(torch.int32), dim=-1) - 1   # in [0, n)
    lead = seg.shape[:-1]
    rows = torch.arange(seg[..., 0].numel(), device=seg.device).view(
        lead + (1,))
    flat = (rows * n + seg).reshape(-1)

    def segment_sum(v):
        out = torch.zeros(flat.shape[0], dtype=torch.float64, device=v.device)
        out.index_add_(0, flat, v.reshape(-1).to(torch.float64))
        return out.view(lead + (n,)).to(torch.float32)

    cnt = segment_sum(torch.ones_like(r))
    den = torch.clamp(cnt, min=1.0)
    mean_r = segment_sum(r_eff) / den
    cos_a, sin_a = rounded64(torch.cos, angles), rounded64(torch.sin, angles)
    cx = segment_sum(r * cos_a) / den
    cy = segment_sum(r * sin_a) / den

    n_seg = seg[..., -1:] + 1
    sid = torch.arange(n, device=seg.device)
    live = sid < n_seg
    prev_r = torch.where(sid >= 1, _shift(mean_r, 1, _FAR), _FAR)
    next_r = torch.where(sid + 1 < n_seg, _shift(mean_r, -1, _FAR), _FAR)

    width = cnt * _ARC * mean_r   # arc-length approximation
    is_pillar = (live & (mean_r < max_range) & (cnt >= min_beams)
                 & (width <= max_width)
                 & (prev_r > mean_r + gap) & (next_r > mean_r + gap))
    return _detections(_polar(cx, cy), is_pillar, max_out)


_SCAN_BLOCK = 16


def _running_sum(v: torch.Tensor) -> torch.Tensor:
    """Sequential inclusive prefix sums along a short last axis."""
    out = [v[..., 0]]
    for j in range(1, v.shape[-1]):
        out.append(out[-1] + v[..., j])
    return torch.stack(out, dim=-1)


def cumsum32(v: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sums along the last axis, added in the order of
    XLA:CPU's ``jnp.cumsum``: sequential within blocks of 16, and each
    block offset by the exclusive prefix of the block totals, which are
    scanned the same way. Elementwise adds only, so every device gives the
    same bits."""
    n = v.shape[-1]
    if n <= _SCAN_BLOCK:
        return _running_sum(v)
    m = -(-n // _SCAN_BLOCK)
    pad = v.new_zeros(v.shape[:-1] + (m * _SCAN_BLOCK - n,))
    inner = _running_sum(torch.cat([v, pad], dim=-1).view(
        v.shape[:-1] + (m, _SCAN_BLOCK)))
    totals = cumsum32(inner[..., -1])
    before = torch.cat([torch.zeros_like(totals[..., :1]),
                        totals[..., :-1]], dim=-1)
    return (inner + before[..., None]).flatten(-2)[..., :n]


def _window_sums(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sums over the windows [i-k, i-1] and [i+1, i+k] (clipped to the
    array) as differences of f32 prefix sums, the JAX package's form."""
    n = v.shape[-1]
    ps = torch.cat([torch.zeros_like(v[..., :1]), cumsum32(v)], dim=-1)
    i = torch.arange(n, device=v.device)
    lead = v.shape[:-1] + (n,)

    def at(idx):
        return torch.gather(ps, -1, idx.expand(lead))

    left = at(i) - at(torch.clamp(i - k, min=0))
    right = at(torch.clamp(i + 1 + k, max=n)) - at(i + 1)
    return left, right


def _fms(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a - b * c`` with the product unrounded, as the fused multiply-add
    XLA:CPU contracts it into (the f32 product is exact in float64)."""
    f64 = torch.float64
    return (a.to(f64) - b.to(f64) * c.to(f64)).to(torch.float32)


def _side_stats(xl, yl, xxl, yyl, xyl, cnt):
    """Major-axis direction and smaller eigenvalue of a window's scatter.
    The covariances subtract nearly equal numbers (a 12-beam window's
    spread against its mean's square), so the rounding of ``mx * mx``
    moves the direction by up to 1e-4 rad: the subtractions keep XLA's
    fused form, which brings the corners to within 1e-6 m of the JAX
    package's (1.6e-5 m with separate roundings)."""
    c = torch.clamp(cnt, min=1.0)
    mx, my = xl / c, yl / c
    cxx = _fms(xxl / c, mx, mx)
    cyy = _fms(yyl / c, my, my)
    cxy = _fms(xyl / c, mx, my)
    ang = 0.5 * rounded64(torch.atan2, 2.0 * cxy, cxx - cyy)
    tr = cxx + cyy
    det = _fms(cxx * cyy, cxy, cxy)
    disc = rounded64(torch.sqrt, torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return ang, tr / 2.0 - disc


def extract_corners(ranges: torch.Tensor, angles: torch.Tensor,
                    range_min: float = 0.023, usable_range: float = 24.0,
                    k: int = 12, gap: float = 0.3,
                    min_angle: float = 0.5, max_resid: float = 0.0012,
                    max_range: float = 12.0, max_out: int = 16
                    ) -> LandmarkDetections:
    """Wall-intersection corners in scans (..., N): the precise landmark
    class (an exact world point, where a pillar's arc centroid moves with
    the viewpoint)."""
    n = ranges.shape[-1]
    r = ranges.to(torch.float32)
    ok = (r >= range_min) & (r <= usable_range)
    x = r * rounded64(torch.cos, angles)
    y = r * rounded64(torch.sin, angles)

    # continuity: a window is usable only if every |dr| within it is small
    dr = torch.abs(r[..., 1:] - r[..., :-1])
    brk = torch.cat([torch.ones_like(dr[..., :1], dtype=torch.bool),
                     dr > gap], dim=-1) | ~ok
    brk_ps = torch.cumsum(brk.to(torch.int32), dim=-1)

    ones = ok.to(torch.float32)
    cl, cr = _window_sums(ones, k)
    xl, xr = _window_sums(x * ones, k)
    yl, yr = _window_sums(y * ones, k)
    xxl, xxr = _window_sums(x * x * ones, k)
    yyl, yyr = _window_sums(y * y * ones, k)
    xyl, xyr = _window_sums(x * y * ones, k)
    ang_l, min_l = _side_stats(xl, yl, xxl, yyl, xyl, cl)
    ang_r, min_r = _side_stats(xr, yr, xxr, yyr, xyr, cr)

    # window continuity: no break strictly inside (i-k, i+k]
    i = torch.arange(n, device=r.device)
    lo = torch.clamp(i - k, min=0).expand(brk_ps.shape)
    hi = torch.clamp(i + k, max=n - 1).expand(brk_ps.shape)
    contiguous = (torch.gather(brk_ps, -1, hi)
                  == torch.gather(brk_ps, -1, lo))
    full = (cl >= k) & (cr >= k)                        # not at array edges

    two_d = 2.0 * (ang_l - ang_r)
    dang = rounded64(
        lambda d: torch.abs(torch.atan2(torch.sin(d), torch.cos(d))),
        two_d) / 2.0
    is_corner = (ok & contiguous & full & (r < max_range)
                 & (dang > min_angle)
                 & (min_l < max_resid) & (min_r < max_resid))
    score = torch.where(is_corner, dang, -1.0)

    # non-maximum suppression over +-k beams (circular, as jnp.roll)
    best = score
    for s in range(1, k + 1):
        best = torch.maximum(best, torch.roll(score, s, dims=-1))
        best = torch.maximum(best, torch.roll(score, -s, dims=-1))
    keep = is_corner & (score >= best)
    # a plateau keeps only its first beam
    keep = keep & ~_shift(keep, 1, False)

    # the corner is the intersection of the two fitted lines
    mxl, myl = xl / torch.clamp(cl, min=1.0), yl / torch.clamp(cl, min=1.0)
    mxr, myr = xr / torch.clamp(cr, min=1.0), yr / torch.clamp(cr, min=1.0)
    dlx, dly = rounded64(torch.cos, ang_l), rounded64(torch.sin, ang_l)
    drx, dry = rounded64(torch.cos, ang_r), rounded64(torch.sin, ang_r)
    denom = dlx * dry - dly * drx            # != 0 where dang > min_angle
    usable = torch.abs(denom) >= 1e-6
    tt = ((mxr - mxl) * dry - (myr - myl) * drx) / torch.where(
        usable, denom, 1.0)
    px_c = torch.where(keep & usable, mxl + tt * dlx, x)
    py_c = torch.where(keep & usable, myl + tt * dly, y)
    return _detections(_polar(px_c, py_c), keep, max_out)


def extract_all(ranges: torch.Tensor, angles: torch.Tensor,
                max_out: int = 16, pillar_kw: dict | None = None,
                corner_kw: dict | None = None) -> LandmarkDetections:
    """Corners first (precise), then pillars, compacted into M slots."""
    corners = extract_corners(ranges, angles, max_out=max_out,
                              **(corner_kw or {}))
    pillars = extract_landmarks(ranges, angles, max_out=max_out,
                                **(pillar_kw or {}))
    rb = torch.cat([corners.rb, pillars.rb], dim=-2)        # (..., 2M, 2)
    val = torch.cat([corners.valid, pillars.valid], dim=-1)
    return _detections(rb, val, max_out)


def extract_landmarks_batch(ranges_all: torch.Tensor, angles: torch.Tensor,
                            corners: bool = True, **kw) -> LandmarkDetections:
    """Whole-log extraction: (T, N) -> rb (T, M, 2), valid (T, M), count
    (T,). With ``corners``, corners and pillars (``extract_all``); the range
    gates go to both detectors, every other keyword to the pillars."""
    if not corners:
        return extract_landmarks(ranges_all, angles, **kw)
    max_out = kw.pop("max_out", 16)
    shared = {k_: v for k_, v in kw.items()
              if k_ in ("range_min", "usable_range", "max_range")}
    return extract_all(ranges_all, angles, max_out=max_out, pillar_kw=kw,
                       corner_kw=shared)
