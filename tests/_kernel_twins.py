"""CPU twins of kernels K1 (``csrc/edt.cu``), K2 (``csrc/corr_volume.cu``),
K3 (``csrc/scan_match.cu``), K4 (``csrc/vol_lookup.cu``) and K5
(``csrc/scan_intake.cu``).

A CUDA kernel cannot run without a card, so each kernel has a twin here in
plain PyTorch or numpy that repeats its index math step by step: bit-packed
rows, bit-scan distances and row bands for K1; beam chunks, live-beam
compaction, bounding-box tiles and their halving, lattice codes with the
bounds test folded in, and window origins for K2; gather tables with the
bounds test folded in, integer code sums, the penalty after the sum and
compaction by prefix count for K3; one pose a thread through the
cascade's levels, stopping at the first window that holds it, and the
refinement's serial first minimum for K4; contiguous runs of beams a
thread, warp scans of their kept counts and each kept beam's slot and
quadrant for K5. ``test_torch_kernel_twins.py`` holds
them to the plain versions; they are slow and only the tests use them.
"""

import numpy as np
import torch

from lidar_slam_tpu_torch.ops import correlative
from lidar_slam_tpu_torch.ops.cuda_edt import plan_band
from lidar_slam_tpu_torch.ops.cuda_match import (LATTICE_BITS, plan,
                                                 tile_pitch, window_cells)
from lidar_slam_tpu_torch.ops.edt import quantize_metric
from lidar_slam_tpu_torch.ops.matching import MatchResult

_INF_D2 = 1 << 20


def _msb(v: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each nonzero 32-bit value."""
    return sum(((v >> j) != 0).long() for j in range(32)) - 1


def _lsb(v: torch.Tensor) -> torch.Tensor:
    """Index of the lowest set bit of each nonzero 32-bit value."""
    return _msb(v & -v)


def edt_twin(occ: torch.Tensor, max_dist: int = 10, band: int | None = None,
             sms: int = 132, stats: dict | None = None) -> torch.Tensor:
    """K1's index math: occupancy packed 32 cells a word with two zero
    words at each end of a row; each cell's nearest occupied cell in its
    row from the bits of its own word and its neighbours' (the second word
    each side only when R > 32); the column pass band by band over the
    band's rows plus R halo rows each side. The same result as
    ``edt_clamped_cuda``; ``stats`` receives the band height and the number
    of blocks."""
    h, w = occ.shape[-2:]
    occ3 = occ.reshape(-1, h, w).to(torch.bool)
    b = occ3.shape[0]
    r = int(max_dist)
    band = plan_band(b, h, w, r, sms, band)
    nw = -(-w // 32)
    cells = torch.zeros((b, h, nw * 32), dtype=torch.int64)
    cells[..., :w] = occ3.long()
    words = (cells.view(b, h, nw, 32) << torch.arange(32)).sum(-1)
    words = torch.nn.functional.pad(words, (2, 2))        # (b, h, nw + 4)
    x = torch.arange(w)
    k, s = x // 32 + 2, x % 32
    mid = words[..., k]
    left, right = words[..., k - 1], words[..., k + 1]
    left2, right2 = words[..., k - 2], words[..., k + 2]
    wide = r > 32
    # free cells beyond the word on each side (96: none within reach)
    nf = torch.where(right != 0, _lsb(right),
                     torch.where(wide & (right2 != 0), 32 + _lsb(right2), 96))
    pl = torch.where(left != 0, 31 - _msb(left),
                     torch.where(wide & (left2 != 0), 63 - _msb(left2), 96))
    # right: cells x .. x + 31 - s in this word, then beyond it
    a = mid >> s
    dr = torch.where(a != 0, _lsb(a), 32 - s + nf)
    # left: cells x - s .. x in this word, then beyond it
    a = mid & (2 ** (s + 1) - 1)
    dl = torch.where(a != 0, s - _msb(a), s + 1 + pl)
    d = torch.minimum(dl, dr)
    d1 = torch.where(d <= r, d * d, _INF_D2)                # (b, h, w)
    d1 = torch.nn.functional.pad(d1, (0, 0, r, r), value=_INF_D2)
    best = torch.empty((b, h, w), dtype=torch.int64)
    blocks = 0
    for y0 in range(0, h, band):
        rows = min(band, h - y0)
        slab = d1[:, y0:y0 + rows + 2 * r]     # band rows y0-R .. y0+rows+R
        best[:, y0:y0 + rows] = torch.stack(
            [slab[:, t:t + rows] + (t - r) ** 2 for t in range(2 * r + 1)]
        ).amin(0)
        blocks += b
    dist = torch.clamp(torch.sqrt(best.to(torch.float32)), max=float(r))
    if stats is not None:
        stats.update(band=band, blocks=blocks)
    return quantize_metric(dist).reshape(occ.shape)


def box_columns(c_lo: int, c_hi: int) -> tuple[int, int]:
    """(first column, width) of a staged tile covering columns c_lo ..
    c_hi - 1: whole quads, the first one 4-aligned."""
    c0 = c_lo & ~3
    return c0, (c_hi - c0 + 3) & ~3


def score_volume_twin(metric: torch.Tensor, cx0: torch.Tensor,
                      cy0: torch.Tensor, valid: torch.Tensor, n_rows, n_cols,
                      half: int, lattice_bits: int = LATTICE_BITS,
                      chunk: int | None = None, tile_cells: int | None = None,
                      sms: int = 132, stats: dict | None = None
                      ) -> torch.Tensor:
    """K2's index math, block by block: the same shapes and result as
    ``score_volume_cuda``. ``chunk``/``tile_cells`` override the plan (a
    small budget forces the halving); ``stats`` receives the number of
    blocks and of staged pieces."""
    lead = tuple(metric.shape[:-2])
    s = metric.shape[-1]
    t_bins, n = cx0.shape[-2:]
    m = metric.reshape(-1, s, s)
    b = m.shape[0]
    cx = cx0.reshape(b, t_bins, n).long()
    cy = cy0.reshape(b, t_bins, n).long()
    v = valid.reshape(b, n)
    planned, tile = plan(b, t_bins, n, half, sms)
    chunk = chunk or planned
    tile_cells = tile_cells or tile
    w = 2 * half + 1
    if tile_cells < window_cells(half):
        raise ValueError("the tile budget must hold one window")
    nr, nc = int(n_rows), int(n_cols)
    row_hi = 0 if nr <= 1 else min(nr - 1, s)
    col_hi = 0 if nc <= 1 else min(nc - 1, s)
    up, down = 2.0 ** lattice_bits, 2.0 ** -lattice_bits
    o = torch.arange(w * w)
    scores = torch.zeros((b, t_bins, w * w), dtype=torch.float32)
    blocks = pieces = 0
    for bi in range(b):
        for n0 in range(0, n, chunk):
            blocks += 1
            ns = torch.arange(n0, min(n0 + chunk, n))
            ycl = torch.where(v[bi, ns],                         # (T, n)
                              cy[bi][:, ns].clamp(-half, row_hi + half),
                              -half)
            xcl = cx[bi][:, ns].clamp(-half, col_hi + half)
            meets = ((ycl + half >= 1) & (ycl - half < row_hi)
                     & (xcl + half >= 1) & (xcl - half < col_hi)).any(0)
            live = torch.nonzero(meets).flatten()
            n_live = len(live)
            i0, i1, t0, t1 = 0, n_live, 0, t_bins
            while i0 < n_live:
                ys = ycl[t0:t1, live[i0:i1]]
                xs = xcl[t0:t1, live[i0:i1]]
                br0 = int(ys.min()) - half
                rows = int(ys.max()) - int(ys.min()) + w
                bc0, width = box_columns(int(xs.min()) - half,
                                         int(xs.max()) + half + 1)
                pitch = tile_pitch(width)
                np_, nt = i1 - i0, t1 - t0
                if rows * pitch > tile_cells or (
                        np_ > 1 and 2 * rows * width > np_ * nt * w * w):
                    if i1 - i0 > 1:
                        i1 = i0 + (i1 - i0) // 2
                    else:
                        t1 = t0 + (t1 - t0) // 2
                    continue
                pieces += 1
                gr = br0 + torch.arange(rows)
                gc = bc0 + torch.arange(width)
                ok = (((gr >= 1) & (gr < row_hi))[:, None]
                      & ((gc >= 1) & (gc < col_hi))[None, :])
                vals = m[bi][gr.clamp(0, s - 1)][:, gc.clamp(0, s - 1)] * up
                code = vals.trunc()
                bad = bool((ok & ((code != vals) | (code < 0)
                                  | (code > 65535))).any())
                tile_codes = torch.zeros((rows, pitch), dtype=torch.int64)
                tile_codes[:, :width] = torch.where(ok, code, 0.0).long()
                base = (ys - half - br0) * pitch + (xs - half - bc0)
                off = (o // w) * pitch + o % w
                acc = tile_codes.flatten()[base[..., None] + off].sum(dim=1)
                if bad:
                    scores[bi, t0:t1] += float("nan")
                else:
                    scores[bi, t0:t1] += acc.to(torch.float32) * down
                if t1 < t_bins:
                    t0, t1 = t1, t_bins
                else:
                    i0, i1, t0, t1 = i1, n_live, 0, t_bins
    if stats is not None:
        stats.update(blocks=blocks, pieces=pieces)
    return scores.reshape(lead + (t_bins, w, w))


_F = np.float32


def _roundf_like_np(v: np.ndarray) -> np.ndarray:
    return np.trunc(v + np.sign(v) * _F(0.5))


def _sincos32_np(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``core/trig32.sincos32`` in numpy float32, as the kernel computes it
    (its constants are the module's)."""
    from lidar_slam_tpu_torch.core import trig32 as t

    x = x.astype(_F)
    k = _roundf_like_np(x * _F(t._TWO_OVER_PI))
    r = ((x - k * _F(t._PIO2_H1)) - k * _F(t._PIO2_H2)) - k * _F(t._PIO2_H3)
    r2 = r * r
    sp = (r2 * _F(t._S3) + _F(t._S2)) * r2 + _F(t._S1)
    sinr = (sp * r2) * r + r
    cp = (r2 * _F(t._C3) + _F(t._C2)) * r2 + _F(t._C1)
    cosr = (cp * r2) * r2 + (_F(1.0) - r2 * _F(0.5))
    q = np.remainder(k.astype(np.int32), 4)
    sin = np.choose(q, [sinr, cosr, -sinr, -cosr])
    cos = np.choose(q, [cosr, -sinr, -cosr, sinr])
    return sin, cos


def scan_match_twin(metric, grid, scan_x, scan_y, valid, pose, step_t,
                    step_r, window_t=1, window_r=1,
                    window_penalty_px=1.0) -> MatchResult:
    """K3's algorithm in numpy: the candidates' coordinates and headings
    once; for each (heading, x offset) a beam's clamped column or -1 (bounds
    and valid folded in), for each (heading, y offset) its clamped row or
    -1; each candidate's sum of integer lattice codes over the beams whose
    two entries are >= 0 (a value off the lattice, or a sum that reaches
    2^24, poisons its score with NaN); the penalty added after the sum; the
    first minimum, NaN first; the last candidate's hits compacted by a prefix
    count. The same result as ``fast_match_cuda``."""
    m = metric.numpy()
    s = m.shape[-1]
    x, y, v = scan_x.numpy(), scan_y.numpy(), valid.numpy()
    p, org = pose.numpy(), grid.origin.numpy()
    n_rows, n_cols = int(grid.n_rows), int(grid.n_cols)
    ipixel = _F(1.0 / grid.pixel)
    nt, nr = 2 * window_t + 1, 2 * window_r + 1
    n = x.shape[0]
    tx = p[0] + np.arange(-window_t, window_t + 1).astype(_F) * _F(step_t)
    ty = p[1] + np.arange(-window_t, window_t + 1).astype(_F) * _F(step_t)
    th = p[2] + np.arange(-window_r, window_r + 1).astype(_F) * _F(step_r)
    offx, offy = (tx - org[0]) * ipixel, (ty - org[1]) * ipixel
    sin, cos = _sincos32_np(th)
    px, py = x * ipixel, y * ipixel
    sx = px[None] * cos[:, None] + py[None] * sin[:, None]         # (nr, N)
    sy = (-px)[None] * sin[:, None] + py[None] * cos[:, None]
    cx = _roundf_like_np(sx[:, None] + offx[None, :, None]).astype(np.int32) + 1
    cy = _roundf_like_np(sy[:, None] + offy[None, :, None]).astype(np.int32) + 1
    tab_x = np.where(v & (cx > 1) & (cx < n_cols), np.clip(cx - 1, 0, s - 1),
                     -1).astype(np.int16)                        # (nr, nt, N)
    tab_y = np.where((cy > 1) & (cy < n_rows), np.clip(cy - 1, 0, s - 1),
                     -1).astype(np.int16)
    ix = np.broadcast_to(tab_x[:, :, None], (nr, nt, nt, n)).reshape(-1, n)
    iy = np.broadcast_to(tab_y[:, None, :], (nr, nt, nt, n)).reshape(-1, n)
    hit = (ix.astype(np.int32) | iy) >= 0                          # (C, N)
    vals = np.where(hit, m[np.maximum(iy, 0), np.maximum(ix, 0)], _F(0))
    scaled = vals * _F(1024.0)
    with np.errstate(invalid="ignore"):
        codes = np.clip(np.where(np.isfinite(scaled), scaled, -1), -1,
                        2.0 ** 31).astype(np.int64)
    bad = hit & ((codes.astype(_F) != scaled) | (codes < 0))
    sums = np.where(hit, np.maximum(codes, 0), 0).sum(axis=1)
    bad = bad.any(axis=1) | (sums >= 1 << 24)
    counts = hit.sum(axis=1).astype(np.int32)
    scores = np.where(bad, _F(np.nan),
                      sums.astype(_F) * _F(2.0 ** -10)).astype(_F)
    if window_t > 1 or window_r > 1:
        et = np.maximum(np.abs(np.arange(-window_t, window_t + 1)) - 1,
                        0).astype(_F)
        er = np.maximum(np.abs(np.arange(-window_r, window_r + 1)) - 1,
                        0).astype(_F)
        excess = ((er[:, None, None] + et[None, :, None])
                  + et[None, None, :]).reshape(-1)
        scores = scores + _F(window_penalty_px) * excess
    nan = np.isnan(scores)
    best = int(np.argmax(nan)) if nan.any() else int(np.argmin(scores))
    h, i, j = best // (nt * nt), (best // nt) % nt, best % nt
    last = hit[-1]
    slot = np.cumsum(last) - 1          # hits before each beam: its slot
    last_hits = np.zeros(n, _F)
    last_hits[slot[last]] = vals[-1][last]
    return MatchResult(pose=torch.as_tensor(np.asarray([tx[i], ty[j], th[h]],
                                                       _F)),
                       score=torch.as_tensor(scores[best]),
                       best_count=torch.as_tensor(counts[best]),
                       last_hits=torch.as_tensor(last_hits),
                       last_inb=torch.as_tensor(last))


def _clamp_keep_nan(v: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return np.where(np.isnan(v), v, np.minimum(np.maximum(v, _F(lo)), _F(hi)))


def _corner(floored: np.ndarray) -> np.ndarray:
    return np.where(np.isnan(floored), 0, floored).astype(np.int64)


def _vol_level_twin(vol, lvl: int, rows: np.ndarray, p: np.ndarray):
    """K4's ``lookup`` at level ``lvl`` for poses p (n, 3) of volume rows
    ``rows`` (n,): each float32 operation in the kernel's order. Returns
    (distance times 2^lvl, inside the level's window)."""
    t, w = vol.scores.shape[-3], vol.scores.shape[-1]
    half = vol.half
    scores = vol.scores.numpy().reshape(-1, t * w * w)[rows]
    counts = vol.counts.numpy().reshape(-1, t * w * w)[rows]
    base = vol.base_pose.numpy().reshape(-1, 3)[rows]
    ipix, step = _F(vol.ipixel), _F(vol.theta_step)
    fdx = (p[:, 0] - base[:, 0]) * ipix + _F(half)
    fdy = (p[:, 1] - base[:, 1]) * ipix + _F(half)
    fdt = (p[:, 2] - base[:, 2]) / step + _F(t // 2)
    inside = ((fdx >= 0) & (fdx <= 2 * half) & (fdy >= 0) & (fdy <= 2 * half)
              & (fdt >= 0) & (fdt <= t - 1))
    ft = _clamp_keep_nan(fdt, 0.0, t - 1)
    fy = _clamp_keep_nan(fdy, 0.0, w - 1)
    fx = _clamp_keep_nan(fdx, 0.0, w - 1)
    t0, y0, x0 = np.floor(ft), np.floor(fy), np.floor(fx)
    at, ay, ax = ft - t0, fy - y0, fx - x0
    wt, wy, wx = (_F(1) - at, at), (_F(1) - ay, ay), (_F(1) - ax, ax)
    it, iy, ix = _corner(t0), _corner(y0), _corner(x0)
    num = np.zeros(p.shape[0], _F)
    den = np.zeros(p.shape[0], _F)
    cell = np.arange(p.shape[0])
    for dt in (0, 1):
        ti = np.minimum(it + dt, t - 1)
        for dy in (0, 1):
            yi = np.minimum(iy + dy, w - 1)
            for dx in (0, 1):
                xi = np.minimum(ix + dx, w - 1)
                idx = (ti * w + yi) * w + xi
                wgt = (wt[dt] * wy[dy]) * wx[dx]
                num = num + wgt * scores[cell, idx]
                den = den + wgt * counts[cell, idx]
    d = num / np.where(np.isnan(den), den, np.maximum(den, _F(1)))
    return (d if lvl == 0 else d * _F(2 ** lvl)), inside


def _cascade_twin(vols, rows: np.ndarray, p: np.ndarray):
    """K4's ``cascade``: the first level whose window holds the pose (the
    coarsest where none does); the fine window's escape mask."""
    dist, inside = _vol_level_twin(vols[0], 0, rows, p)
    escape, chosen = ~inside, inside
    for lvl in range(1, len(vols)):
        d, inside = _vol_level_twin(vols[lvl], lvl, rows, p)
        dist = np.where(chosen, dist, d)
        chosen = chosen | inside
    return dist, escape


def vol_lookup_twin(vols, poses: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's lookup in numpy: one pose at a time in effect (every operation
    elementwise), pose i of (B, K, 3) looking up volume row i // K. The
    same (dist, escape) as ``lookup_cascade_cuda``; its dist alone is
    ``lookup_avg_distance_cuda``'s for one level."""
    lead = tuple(poses.shape[:-1])
    p = poses.numpy().reshape(-1, 3).astype(_F)
    b = vols[0].scores.shape[0] if vols[0].scores.dim() == 4 else 1
    rows = np.arange(p.shape[0]) // max(1, p.shape[0] // b)
    with np.errstate(invalid="ignore"):
        dist, escape = _cascade_twin(vols, rows, p)
    return (torch.as_tensor(dist.astype(_F)).reshape(lead),
            torch.as_tensor(escape).reshape(lead))


def vol_refine_twin(vols, est_pose: torch.Tensor, offs: torch.Tensor
                    ) -> torch.Tensor:
    """K4's refinement in numpy: ``correlative.REFINE_PASSES`` times the
    candidates est + offs, their cascade distances and thread 0's serial
    first minimum (the first NaN where there is one). The same estimate as
    ``refine_estimate_cuda``."""
    est, o = est_pose.numpy().astype(_F), offs.numpy().astype(_F)
    rows = np.zeros(o.shape[0], np.int64)
    for _ in range(correlative.REFINE_PASSES):
        cands = est[None, :] + o
        with np.errstate(invalid="ignore"):
            d, _ = _cascade_twin(vols, rows, cands)
        best, v = 0, d[0]
        for j in range(1, len(d)):
            if np.isnan(v):
                break
            if np.isnan(d[j]) or d[j] < v:
                best, v = j, d[j]
        est = cands[best]
    return torch.as_tensor(est.astype(_F))


def scan_intake_twin(ranges: torch.Tensor, angles: torch.Tensor, cfg):
    """K5's algorithm in numpy: thread t of the block owns the contiguous
    run of beams [t ipt, (t + 1) ipt) and gates them in float32; each warp
    scans its threads' kept counts as the shuffles do (lane l adds lane
    l - o for o = 1, 2, 4, 8, 16), warp 0 scans the warps' totals the same
    way, and a thread's first kept beam goes to its warp's exclusive offset
    plus its inclusive count less its own; each kept beam's sin and cos
    (the kernel's sincos32, quadrant by floor-mod) and x = r cos, y = r sin
    at its slot; zeros past the size. The same ``Scan`` as
    ``read_scan_cuda``."""
    from lidar_slam_tpu_torch.core.sensor import Scan
    from lidar_slam_tpu_torch.ops import cuda_scan_intake as k5

    r = ranges.numpy().astype(_F)
    n = r.shape[0]
    threads, lanes = k5.THREADS, 32
    ipt = -(-n // threads)
    assert 1 <= ipt <= k5.PER_THREAD, n
    lo, hi = (_F(b) for b in k5.gate_bounds(cfg))
    with np.errstate(invalid="ignore"):
        ok = (r >= lo) & (r <= hi)
    b0 = np.minimum(n, np.arange(threads) * ipt)
    b1 = np.minimum(n, b0 + ipt)
    kept_before = np.concatenate([[0], np.cumsum(ok)])
    mine = kept_before[b1] - kept_before[b0]            # a thread's count

    def warp_scan(v):                                   # (warps, 32)
        v = v.copy()
        o = 1
        while o < lanes:
            up = np.zeros_like(v)
            up[:, o:] = v[:, :-o]                       # __shfl_up_sync
            v = v + up
            o <<= 1
        return v

    incl = warp_scan(mine.reshape(-1, lanes))
    totals = warp_scan(incl[:, -1][None, :])[0]         # warp 0's scan
    offset = totals - incl[:, -1]
    total = int(totals[-1])
    first = (offset[:, None] + incl - mine.reshape(-1, lanes)).reshape(-1)
    beams = np.flatnonzero(ok)
    owner = beams // ipt
    slot = first[owner] + (kept_before[beams] - kept_before[b0[owner]])
    sin, cos = _sincos32_np(angles.numpy()[beams])
    x, y = np.zeros(n, _F), np.zeros(n, _F)
    x[slot] = r[beams] * cos
    y[slot] = r[beams] * sin
    return Scan(x=torch.as_tensor(x), y=torch.as_tensor(y),
                valid=torch.as_tensor(np.arange(n) < total),
                size=torch.tensor(total, dtype=torch.int32))
